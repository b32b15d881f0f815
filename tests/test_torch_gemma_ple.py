"""The per-layer-embedding Gemmas (gemma4, gemma3n) in the port held against
the JAX package on the CPU: the config keys, the per-layer token stream,
gemma4's attention (the weightless V norm, V as K where a layer has no wv)
and its per-layer output scale, the shared-KV layers (banks for the owning
layers only, no store on the others), gemma3n's AltUp layer with LAuReL and
the activation sparsity, the layer kernel kept off, the context shift on a
20-bank cache, ServerContexts, the weights carried across and the card's
synth. The JAX oracle loads with fuse=False: its gemma3n layer reads
ffn_gate and ffn_up, which a fused load of a K-major file renames (pinned
below); the port loads with its default fused layout.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_gemma_ple.py -q
"""
import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGMLType
from tpullm.models.llama import KVCache as JKVCache
from tpullm.models.llama import forward as jforward
from tpullm.ops.layer_kernel import supported as jblock_supported
from tpullm.ops.qtensor import QTensor as JQTensor
from tpullm.ops.qtensor import qtensor_from_bytes as jqtensor_from_bytes
from tpullm.quant.numpy_impl import quantize
from tpullm.runtime.engine import InferenceEngine as JEngine
from tpullm.runtime.loader import load_model as jload
from tpullm.runtime.memory import SlotMemory as JSlotMemory
from tpullm.server.context import GenParams as JGenParams
from tpullm.server.context import ServerContext as JServerContext
from tpullm.server.context import Task as JTask
from tpullm.utils.synth import build_gemma3n_gguf, build_gemma4_gguf
import tpullm_torch.models.llama as llama
from tpullm_torch.models.config import ModelConfig, config_from_gguf
from tpullm_torch.models.llama import (KVCache, bank_map, check_dense, forward, layer_routes,
                                       per_layer_inputs, swa_flags)
from tpullm_torch.ops.qtensor import QTensor, qtensor_from_bytes
from tpullm_torch.runtime.engine import InferenceEngine
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.runtime.memory import SlotMemory
from tpullm_torch.server.context import GenParams, ServerContext, Task
from tpullm_torch.utils.from_jax import kv_cache_from_numpy, params_from_numpy
from tpullm_torch.utils.synth import synth_gemma3n

torch.set_num_threads(2)

# the synth files: the JAX package's own (tests/test_gemma4.py seed 3,
# tests/test_gemma3n.py seed 5) at their small widths, gemma3n at a K-major
# width (Q4_K, n_embd 512: the fused wqkv and gate/up) and at 12 layers (no
# shared layer), gemma4 at a K-major width and without shared layers
FILES = {
    "gemma4": (build_gemma4_gguf, dict(seed=3)),
    "gemma3n": (build_gemma3n_gguf, dict(seed=5)),
    "gemma3n-kmajor": (build_gemma3n_gguf, dict(n_embd=512, n_ff=1024, head_dim=128,
                                                qtype=GGMLType.Q4_K, seed=5)),
    "gemma4-kmajor": (build_gemma4_gguf, dict(n_embd=512, n_ff=1024, head_dim=128,
                                              n_embd_per_layer=256, qtype=GGMLType.Q4_K,
                                              seed=3)),
    "gemma3n-12": (build_gemma3n_gguf, dict(n_layer=12, seed=5)),
    "gemma4-noshare": (build_gemma4_gguf, dict(shared_kv=0, seed=3)),
}
PROMPTS = [[3, 9, 4, 17, 6, 40, 33, 12, 7], [5, 1, 2]]
DECODE_STEPS = 4


def _nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / max((b ** 2).mean(), 1e-30))


def _flatten(v):
    """JAX params -> the plain nested data params_from_numpy takes."""
    if isinstance(v, JQTensor):
        return {"qtype": int(v.qtype), "shape": tuple(v.shape),
                "data": {k: np.asarray(a) for k, a in v.data.items()}}
    if isinstance(v, dict):
        return {k: _flatten(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_flatten(x) for x in v]
    return np.asarray(v)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gemma_ple")
    out = {}
    for name, (build, kw) in FILES.items():
        out[name] = str(d / f"{name}.gguf")
        build(out[name], **kw)
    return out


def _groups(params):
    return params["layers"].get("__groups__") or [params["layers"]]


# ---------------------------------------------------------------- the config

@pytest.mark.parametrize("name", sorted(FILES))
def test_config_matches_jax(files, name):
    """Every field the port parses equals the JAX parser's (config.py:330-339):
    the per-layer width, the owning layers (gemma3n's min(20, n_layer)
    whatever the file says; gemma4's n_layer - shared_kv_layers), the SWA
    array and base, the row's AltUp and sparsity fields."""
    jcfg, _, _ = jload(files[name], fuse=False)
    cfg, _, _ = load_model(files[name], device="cpu")
    fields = lambda c: {k: v for k, v in dataclasses.asdict(c).items() if k != "raw_kv"}
    assert fields(cfg) == fields(jcfg)
    want = {"gemma4": 4, "gemma3n": 20, "gemma3n-kmajor": 20, "gemma4-kmajor": 4,
            "gemma3n-12": 12, "gemma4-noshare": -1}[name]
    assert cfg.n_layer_kv_from_start == want
    check_dense(cfg)


class _Meta:
    """The metadata face of a GGUFFile: all config_from_gguf reads."""

    def __init__(self, arch, metadata):
        self.metadata = {"general.architecture": arch, **metadata}
        self.architecture = arch

    def get(self, key, default=None):
        return self.metadata.get(key, default)


def test_owner_count_and_swa_head_dims():
    """gemma3n's owning layers are min(20, n_layer), its shared_kv_layers
    key unread (the reference fixes the geometry, gemma3n.cpp:9); gemma4's
    are n_layer less the key's count. gemma4's SWA head dims pass where they
    equal the head dims and raise otherwise."""
    base = {"embedding_length": 512, "block_count": 25, "attention.head_count": 4,
            "attention.key_length": 128, "attention.shared_kv_layers": 3,
            "embedding_length_per_layer_input": 256}
    meta = lambda arch, extra={}: _Meta(arch, {f"{arch}.{k}": v for k, v in {**base,
                                                                            **extra}.items()})
    assert config_from_gguf(meta("gemma3n")).n_layer_kv_from_start == 20
    assert config_from_gguf(meta("gemma3n", {"block_count": 12})).n_layer_kv_from_start == 12
    cfg = config_from_gguf(meta("gemma4", {"attention.key_length_swa": 128}))
    assert (cfg.n_layer_kv_from_start, cfg.n_embd_per_layer) == (22, 256)
    with pytest.raises(NotImplementedError, match="key_length_swa"):
        config_from_gguf(meta("gemma4", {"attention.key_length_swa": 256}))


@pytest.mark.parametrize("field,value", [("altup_n", 1), ("altup_act", 4),
                                         ("n_layer_kv_from_start", 1)])
def test_gemma_field_refusals(files, field, value):
    """Outside what the JAX graph runs: a single AltUp stream, an active
    stream past the streams, one owning layer (a shared SWA layer reads
    bank n_layer_kv_from_start - 2)."""
    cfg, _, _ = load_model(files["gemma3n"], device="cpu")
    with pytest.raises(NotImplementedError, match=field):
        check_dense(dataclasses.replace(cfg, **{field: value}))


def test_shared_kv_needs_gemma4_attention_and_sparsity_needs_altup():
    with pytest.raises(NotImplementedError, match="n_layer_kv_from_start"):
        check_dense(ModelConfig(n_layer=4, n_layer_kv_from_start=2))
    with pytest.raises(NotImplementedError, match="n_layer_sparsity"):
        check_dense(ModelConfig(n_layer_sparsity=10))


def test_unread_stream_tensors_raise(files):
    """The per-layer input block without the per-layer stream, and the
    stream's tables without it, raise instead of being dropped."""
    cfg, params, _ = load_model(files["gemma4"], device="cpu")
    cfg0 = dataclasses.replace(cfg, n_embd_per_layer=0)
    assert llama._unread_tensors(cfg0, _groups(params)[0]) == sorted(llama.PLE_KEYS)
    with pytest.raises(NotImplementedError, match="per_layer_tok_embd"):
        llama.check_stream_tables(params, cfg0)
    g3, p3, _ = load_model(files["gemma3n"], device="cpu")
    assert "out_scale" in llama._unread_tensors(g3, {**_groups(p3)[0], "out_scale": None})


# ------------------------------------------------------------- the forward

def _teacher_forced(fwd, params, cfg, mk, cache, n_steps, dtype):
    """Prefill PROMPTS (left-padded) then n_steps decode steps fed the
    given tokens; -> [logits (B, vocab)] of each step. ``mk`` makes the
    framework's arrays."""
    B, T = len(PROMPTS), max(len(p) for p in PROMPTS)
    tok = np.zeros((B, T), np.int64)
    pos = np.zeros((B, T), np.int64)
    for b, p in enumerate(PROMPTS):
        tok[b, T - len(p):] = p
        pos[b, T - len(p):] = np.arange(len(p))
    vf = np.asarray([T - len(p) for p in PROMPTS], np.int64)
    out = []
    lg, cache = fwd(params, cfg, mk(tok), mk(pos), cache, 0, mk(vf), dtype)
    out.append(np.asarray(lg)[:, -1])
    rng = np.random.default_rng(7)
    for s in range(n_steps):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1))
        p = np.asarray([[len(q) + s] for q in PROMPTS])
        lg, cache = fwd(params, cfg, mk(nxt), mk(p), cache, T + s, mk(vf), dtype)
        out.append(np.asarray(lg)[:, -1])
    return out


@pytest.mark.parametrize("name", ["gemma4", "gemma3n", "gemma3n-kmajor", "gemma4-kmajor"])
def test_forward_and_engine_match_jax(files, name):
    """The port (its default load: fused QKV and gate/up where K-major) and
    the JAX forward (fuse=False) over a prefill of two left-padded prompts
    and DECODE_STEPS decode steps in f32 on an f32 cache: NMSE < 1e-6 at
    every step; then both engines' greedy tokens (8 a prompt) are equal."""
    jcfg, jparams, _ = jload(files[name], fuse=False)
    cfg, params, _ = load_model(files[name], device="cpu")
    if name == "gemma3n-kmajor":  # the port's fused layouts, the AltUp layer on them
        own, shared = _groups(params)
        assert {"wqkv", "ffn_gateup"} <= set(own) and {"wq", "ffn_gateup"} <= set(shared)
        assert not {"ffn_gate", "ffn_up", "wk", "wv"} & set(shared)
    S = 32
    j = _teacher_forced(jforward, jparams, jcfg, jnp.asarray,
                        JKVCache.create(jcfg, 2, S, jnp.float32), DECODE_STEPS, jnp.float32)
    with torch.inference_mode():
        t = _teacher_forced(forward, params, cfg, torch.from_numpy,
                            KVCache.create(cfg, 2, S, torch.float32, "cpu"), DECODE_STEPS,
                            torch.float32)
    errs = [_nmse(a, b) for a, b in zip(t, j)]
    assert max(errs) < 1e-6, errs
    jr = JEngine(jcfg, jparams, max_seq_len=64, compute_dtype=jnp.float32,
                 decode_chunk=4).generate(PROMPTS, max_new_tokens=8, return_logits=True)
    r = InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                        decode_chunk=4, device="cpu").generate(PROMPTS, max_new_tokens=8,
                                                                return_logits=True)
    assert _nmse(r.logits, jr.logits) < 1e-6
    assert r.tokens == jr.tokens


def test_params_from_numpy_matches_loader(files):
    """The JAX package's gemma3n params (unfused, f32 AltUp and LAuReL
    arrays, the stream's tables) carried across run as the port's own load
    does."""
    jcfg, jparams, _ = jload(files["gemma3n-kmajor"], fuse=False)
    cfg, params = params_from_numpy(dataclasses.asdict(jcfg), _flatten(jparams), device="cpu")
    assert params["altup_proj"].dtype == torch.float32
    assert isinstance(params["per_layer_tok_embd"], QTensor)
    cfg2, params2, _ = load_model(files["gemma3n-kmajor"], device="cpu")
    eng = lambda c, p: InferenceEngine(c, p, max_seq_len=64, compute_dtype=torch.float32,
                                       decode_chunk=4, device="cpu")
    a = eng(cfg, params).generate(PROMPTS, max_new_tokens=6, return_logits=True)
    b = eng(cfg2, params2).generate(PROMPTS, max_new_tokens=6, return_logits=True)
    assert _nmse(a.logits, b.logits) < 1e-10 and a.tokens == b.tokens


def test_jax_fused_load_raises_keyerror(files):
    """The JAX package's default load fuses a K-major gemma3n file's gate
    and up into ffn_gateup (loader.py:417-420, ops/fuse.py:71-77), and its
    AltUp layer reads ffn_gate and ffn_up (llama.py:1114-1115): the forward
    raises KeyError. Pinned as it computes; the oracle loads with fuse=False
    (ROADMAP §3)."""
    jcfg, jparams, _ = jload(files["gemma3n-kmajor"])
    assert "ffn_gateup" in jparams["layers"]["__groups__"][0]
    with pytest.raises(KeyError, match="ffn_gate"):
        jforward(jparams, jcfg, jnp.asarray([[3, 9]]), jnp.asarray([[0, 1]]),
                 JKVCache.create(jcfg, 1, 16, jnp.float32), 0, jnp.zeros(1, jnp.int32),
                 jnp.float32)


# ------------------------------------------------------------ the cache

@pytest.mark.parametrize("name", ["gemma4", "gemma3n", "gemma4-noshare"])
def test_cache_banks_and_no_store_on_shared_layers(files, name):
    """KVCache.create holds banks for the owning layers alone, as the JAX
    one (llama.py:91-96), on bf16 and int8; bank_map gives each shared
    layer bank nks - 1 (full) or nks - 2 (SWA); a forward stores once an
    owning layer and never on a shared one."""
    jcfg, _, _ = jload(files[name], fuse=False)
    cfg, params, _ = load_model(files[name], device="cpu")
    nks = cfg.n_layer_kv_from_start if cfg.n_layer_kv_from_start >= 0 else cfg.n_layer
    for kv, jkv in ((torch.bfloat16, jnp.bfloat16), ("q8", "q8")):
        c, jc = KVCache.create(cfg, 2, 16, kv, "cpu"), JKVCache.create(jcfg, 2, 16, jkv)
        assert tuple(c.k.shape) == tuple(jc.k.shape) and c.k.shape[0] == nks
        assert (c.ks is None) == (jc.ks is None)
    flags = swa_flags(cfg)
    assert bank_map(cfg, False) == [(False, li) if li < nks else
                                    (False, nks - 2 if flags[li] else nks - 1)
                                    for li in range(cfg.n_layer)]
    calls = []
    real = llama.kv_store

    def counted(*a, **kw):
        calls.append(a[0].data_ptr())
        return real(*a, **kw)

    cache = KVCache.create(cfg, 1, 16, torch.float32, "cpu")
    with mock.patch.object(llama, "kv_store", counted), torch.inference_mode():
        forward(params, cfg, torch.tensor([[3, 9, 4]]), torch.arange(3)[None], cache, 0,
                torch.zeros(1, dtype=torch.int64), torch.float32)
    assert calls == [cache.k[i].data_ptr() for i in range(nks)]


# ------------------------------------------------------------------ the shift

@pytest.mark.parametrize("kv", ["bf16", "q8"])
def test_context_shift_matches_jax(files, kv):
    """The shift of slot 1 (keep 5, discard 9 of 27) on gemma3n's 20-bank
    cache, random rows: the port's and the JAX shift agree as
    tests/test_torch_server.py holds them (NMSE < 1e-5; unmoved rows and V
    bit for bit on bf16). Both rotate every bank at rope_base, the SWA
    layers' banks too (ROADMAP §3)."""
    jcfg, _, _ = jload(files["gemma3n"], fuse=False)
    cfg, _, _ = load_model(files["gemma3n"], device="cpu")
    jm = JSlotMemory(jcfg, 3, 32, {"bf16": jnp.bfloat16, "q8": "q8"}[kv])
    shape = jm.cache.k.shape
    assert shape[0] == 20
    rng = np.random.default_rng(3)
    if kv == "q8":
        jm.cache = JKVCache(*(jnp.asarray(p) for p in (
            rng.integers(-127, 128, shape).astype(np.int8),
            rng.integers(-127, 128, shape).astype(np.int8),
            (rng.random(shape[:-1]) * 0.02).astype(np.float32),
            (rng.random(shape[:-1]) * 0.02).astype(np.float32))))
    else:
        jm.cache = JKVCache(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16),
                            jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
    m = SlotMemory(cfg, 3, 32, {"bf16": torch.bfloat16, "q8": "q8"}[kv], device="cpu")
    m.cache = kv_cache_from_numpy(*(None if a is None else np.asarray(a) for a in (
        jm.cache.k, jm.cache.v, jm.cache.ks, jm.cache.vs)), device="cpu")
    for mem in (jm, m):
        mem.slots[1].tokens = list(range(27))
        mem.slots[1].n_past = 27
        mem.context_shift(1, 5, 9)

    def deq(k, ks):
        k = k.float().numpy() if torch.is_tensor(k) else np.asarray(k, np.float32)
        if ks is None:
            return k
        return k * (ks.numpy() if torch.is_tensor(ks) else np.asarray(ks))[..., None]

    kj, kt = deq(jm.cache.k, jm.cache.ks), deq(m.cache.k, m.cache.ks)
    vj, vt = deq(jm.cache.v, jm.cache.vs), deq(m.cache.v, m.cache.vs)
    assert _nmse(kt, kj) < 1e-5 and _nmse(vt, vj) < 1e-5
    assert m.slots[1].tokens == jm.slots[1].tokens
    if kv != "q8":
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(kt[:, 1, :, :5], kj[:, 1, :, :5])
        np.testing.assert_array_equal(kt[:, 0], kj[:, 0])


# ----------------------------------------------------------------- the server

BURST = [list(range(3, 13)), list(range(40, 52)), [9, 8, 7, 6, 5, 4, 3, 2]]
PAIR = [101, 7, 55, 3, 81, 200]


def _run_server(ctx, task_cls, params_cls, n_new=6):
    """A burst of three greedy requests, then a sequential pair whose second
    prompt extends the first prompt and its completion. -> [(tokens,
    cached_tokens)]."""
    gp = lambda: params_cls(max_tokens=n_new, temperature=0.0)
    tasks = [task_cls(tokens=list(t), params=gp()) for t in BURST]
    for t in tasks:
        ctx.submit(t)
    ctx.start()
    try:
        out = []
        for t in tasks:
            done = [p for k, p in t.events() if k == "done"]
            assert done, "task failed"
            out.append((done[0]["tokens"], done[0]["stats"]["cached_tokens"]))
        first = ctx.generate(list(PAIR), gp())
        second = ctx.generate(PAIR + first["tokens"] + [42, 43], gp())
        out += [(r["tokens"], r["stats"]["cached_tokens"]) for r in (first, second)]
    finally:
        ctx.stop()
    return out


COMMON = dict(max_seq_len=64, decode_chunk=4, prefill_chunk=8)


@pytest.mark.parametrize("name,kv", [("gemma4", "bf16"), ("gemma3n", "bf16"),
                                     ("gemma4-noshare", "q8"), ("gemma3n-12", "q8")])
def test_server_context_matches_jax(files, name, kv):
    """Equal greedy tokens and prefix reuse from the port's and the JAX
    package's ServerContext (token ids, f32 compute, one slot: the JAX
    shared layers read their bank whole and fail on two, pinned below; the
    port's on two slots gives the same tokens). The int8 cache runs on the
    files without shared layers: the JAX shared layers read an int8 bank
    without its scales (pinned below)."""
    jcfg, jparams, _ = jload(files[name], fuse=False)
    cfg, params, _ = load_model(files[name], device="cpu")
    jctx = JServerContext(jcfg, jparams, None, compute_dtype=jnp.float32,
                          kv_dtype={"bf16": jnp.bfloat16, "q8": "q8"}[kv], n_slots=1, **COMMON)
    want = _run_server(jctx, JTask, JGenParams)
    tkv = {"bf16": torch.bfloat16, "q8": "q8"}[kv]
    for n_slots in (1, 2):
        tctx = ServerContext(cfg, params, None, compute_dtype=torch.float32, kv_dtype=tkv,
                             device="cpu", n_slots=n_slots, **COMMON)
        got = _run_server(tctx, Task, GenParams)
        assert [g[0] for g in got] == [w[0] for w in want]
        if n_slots == 1:
            assert got == want
        assert all(len(toks) == 6 for toks, _ in got)
    assert got[-1][1] >= len(PAIR)


def test_jax_shared_layers_read_whole_banks(files):
    """The JAX shared layer reads its bank with every cache row and slot
    (llama.py:1447-1465: no view), so a server with two slots fails at
    the first one-slot prefill (a reshape of 2 rows into 1); and on the int8
    cache it reads the int8 values without their row scales, so its logits
    leave the f32 cache's far behind where the port's stay near (NMSE
    against the f32 cache's: JAX > 1e-2, the port < 1e-3). Pinned as it
    computes (ROADMAP §3)."""
    jcfg, jparams, _ = jload(files["gemma4"], fuse=False)
    jctx = JServerContext(jcfg, jparams, None, compute_dtype=jnp.float32, kv_dtype=jnp.float32,
                          n_slots=2, **COMMON)
    task = JTask(tokens=list(BURST[0]), params=JGenParams(max_tokens=2, temperature=0.0))
    jctx.submit(task)
    jctx.start()
    try:
        events = list(task.events())
    finally:
        jctx.stop()
    assert [k for k, _ in events] == ["error"] and "reshape" in str(events[0][1])
    cfg, params, _ = load_model(files["gemma4"], device="cpu")
    toks = np.asarray([PROMPTS[0]])
    pos = np.arange(toks.shape[1])[None]
    j = {kv: np.asarray(jforward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                                 JKVCache.create(jcfg, 1, 16, kv), 0,
                                 jnp.zeros(1, jnp.int32), jnp.float32)[0])
         for kv in (jnp.float32, "q8")}
    with torch.inference_mode():
        t = {kv: forward(params, cfg, torch.from_numpy(toks), torch.from_numpy(pos),
                         KVCache.create(cfg, 1, 16, kv, "cpu"), 0,
                         torch.zeros(1, dtype=torch.int64), torch.float32)[0].numpy()
             for kv in (torch.float32, "q8")}
    assert _nmse(t[torch.float32], j[jnp.float32]) < 1e-6
    assert _nmse(j["q8"], j[jnp.float32]) > 1e-2 and _nmse(t["q8"], t[torch.float32]) < 1e-3


# ----------------------------------------------------------------- the routes

@pytest.mark.parametrize("name", ["gemma4-kmajor", "gemma3n-kmajor"])
def test_layer_kernel_kept_off(files, name):
    """Neither arch takes the layer kernel at a decode step on the card:
    the JAX gate's post_norms (ops/layer_kernel.py:413) and altup_n
    (llama.py:1396), evaluated on the JAX package's own params, and the
    port's layer_routes, on every layer group of the port's fused load."""
    jcfg, jparams, _ = jload(files[name], fuse=False)
    for jgl in _groups(jparams):
        jqw = {k: v for k, v in jgl.items() if isinstance(v, JQTensor)}
        assert not ("ffn_norm" in jgl and not jcfg.altup_n and jblock_supported(jcfg, jqw))
    cfg, params, _ = load_model(files[name], device="cpu")
    groups = _groups(params)
    for gl in groups:
        qw = {k: v for k, v in gl.items() if isinstance(v, QTensor)}
        assert layer_routes(cfg, gl, qw, 4, 1, True, len(groups)) == (False, False)
    bare = dataclasses.replace(cfg, post_norms=False)  # the port's own conditions alone
    qw = {k: v for k, v in groups[0].items() if isinstance(v, QTensor)}
    assert layer_routes(bare, groups[0], qw, 4, 1, True, len(groups)) == (False, False)


# ------------------------------------------------------ the per-layer table

def test_ids_past_the_table_read_its_last_row():
    """The published Gemma 3n vocabulary (262400) is larger than its
    per-layer table (262144 rows, a multiple of 256: no padding). The JAX
    take_rows of such an id reads the table's last row (an f32 table and an
    unpadded K-major Q4_K one, pinned here); the port clamps the ids on the
    device to the same row, so no gather reads out of range."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(512, 512)).astype(np.float32)
    ids = np.asarray([[3, 511, 512, 1000]])
    raw = quantize(w, GGMLType.Q4_K)
    jq = jqtensor_from_bytes(raw, GGMLType.Q4_K, (512, 512))
    assert jq.layout == "kmajor"
    jrows = np.asarray(jq.take_rows(jnp.asarray(ids), jnp.float32))
    np.testing.assert_array_equal(jrows[0, 2], jrows[0, 1])
    np.testing.assert_array_equal(jrows[0, 3], jrows[0, 1])
    jf = JQTensor(GGMLType.F32, (512, 512), {"w": jnp.asarray(w)})
    np.testing.assert_array_equal(np.asarray(jf.take_rows(jnp.asarray(ids), jnp.float32))[0, 3],
                                  w[511])
    # the port's stream over the same table (2 layers of 256)
    cfg = ModelConfig(arch="gemma4", n_embd=512, n_layer=2, n_embd_per_layer=256)
    table = qtensor_from_bytes(raw, GGMLType.Q4_K, (512, 512))
    params = {"per_layer_tok_embd": table,
              "per_layer_model_proj": qtensor_from_bytes(quantize(w, GGMLType.Q4_K),
                                                         GGMLType.Q4_K, (512, 512)),
              "per_layer_proj_norm": torch.ones(256)}
    x = torch.from_numpy(rng.normal(size=(1, 4, 512)).astype(np.float32))
    got = per_layer_inputs(params, cfg, torch.from_numpy(ids), x, torch.float32)
    want = per_layer_inputs(params, cfg, torch.tensor([[3, 511, 511, 511]]), x, torch.float32)
    assert torch.equal(got, want)
    np.testing.assert_allclose(table.take_rows(torch.tensor([[511]]), torch.float32)[0, 0],
                               jrows[0, 3], rtol=0, atol=1e-6)


# ------------------------------------------------------------- the card's synth

def test_synth_gemma3n_runs_on_the_cpu():
    """synth_gemma3n drawn on the CPU with a torch.Generator at a small
    width (10 layers, 5 owning: one shared layer of each kind): the owning
    and shared groups, Q4_K K-major or planar as the loader lays them out,
    the f32 AltUp and LAuReL arrays; the same generator seed draws the same
    weights; the engine's greedy tokens are finite and in range, with one
    store an owning layer a forward."""
    kw = dict(vocab_size=512, n_embd=512, n_layer=10, n_head=4, n_head_kv=2, head_dim=128,
              n_ff=1024, device="cpu", n_layer_kv_from_start=5, table_rows=500,
              sliding_window=16)
    cfg, params = synth_gemma3n(generator=torch.Generator().manual_seed(0), **kw)
    _, again = synth_gemma3n(generator=torch.Generator().manual_seed(0), **kw)
    own, shared = _groups(params)
    assert own["wqkv"].layout == "kmajor" and shared["wq"].layout == "kmajor"
    assert own["per_layer_proj"].layout == "planar"
    assert params["per_layer_tok_embd"].n_out == 500
    assert own["laurel_l"].dtype == params["altup_proj"].dtype == torch.float32
    assert torch.equal(own["ffn_gateup"].data["q"], again["layers"]["__groups__"][0][
        "ffn_gateup"].data["q"])
    assert bank_map(cfg, False)[5:] == [(False, 3)] * 4 + [(False, 4)]
    calls = []
    real = llama.kv_store
    with mock.patch.object(llama, "kv_store", lambda *a, **k: (calls.append(1), real(*a, **k))[1]):
        r = InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                            decode_chunk=4, device="cpu").generate(
            [[3, 9, 4, 17, 6, 510, 511], [5, 1, 2]], max_new_tokens=5, return_logits=True)
    assert np.isfinite(r.logits).all() and all(0 <= t < 512 for row in r.tokens for t in row)
    assert len(calls) == 5 * (1 + 4)
