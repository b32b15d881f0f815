"""MLA, the compressed-KV attention of the deepseek2 family, in the port held
against the JAX package on the CPU: the config of both GGUF conventions
(split attn_k_b/attn_v_b with the *_mla keys, and the legacy attn_kv_b),
the compressed cache, the absorption banks of the loader's _mla_prepare, a
MoE model with a dense lead and two shared experts through the loader and
params_from_numpy (f32 and int8 caches, YaRN on and off) and a
ServerContext, incremental decode, the attention route and the layer
kernel's gate, and the context shift that rotates only the k_pe tail (a
departure from the JAX package, held against a re-prefill instead).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_mla.py -q
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpullm_torch.models.llama as llama
from tpullm.gguf.writer import GGUFWriter
from tpullm.models.config import ModelConfig as JConfig
from tpullm.models.llama import KVCache as JKVCache
from tpullm.ops.qtensor import QTensor as JQTensor
from tpullm.runtime.engine import InferenceEngine as JEngine
from tpullm.runtime.loader import load_model as jload
from tpullm.runtime.memory import _context_shift as j_context_shift
from tpullm.server.context import GenParams as JGenParams
from tpullm.server.context import ServerContext as JServerContext
from tpullm.server.context import Task as JTask
from tpullm.utils.synth import build_deepseek2_gguf
from tpullm_torch.models.config import ModelConfig
from tpullm_torch.models.llama import (KVCache, _kv_quant, apply_rope, forward, layer_routes,
                                       mla_scale, rope_angles)
from tpullm_torch.runtime.engine import InferenceEngine
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.runtime.memory import SlotMemory, _context_shift
from tpullm_torch.server.context import GenParams, ServerContext, Task
from tpullm_torch.utils.from_jax import params_from_numpy

torch.set_num_threads(2)

PROMPTS = [[3, 9, 4, 17, 6], [5, 1, 2], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 2, 3, 4, 5,
                                         6, 7, 8, 9, 30]]
# DeepSeek-V2-Lite's YaRN keys (factor 40 over 4096; mscale_all_dim 0.707,
# which the GGUF stores as 0.1 x 0.707)
YARN = {"rope.scaling.type": "yarn", "rope.scaling.factor": 40.0,
        "rope.scaling.original_context_length": 4096,
        "rope.scaling.yarn_log_multiplier": 0.0707}
# the MoE model: layer 0 dense, layers 1-2 MoE (4 experts of 64, top-2) with
# two shared experts, at n_embd 256 so that Q8_0's K-major tile takes wq_a,
# wkv_a, the dense FFN and the experts' gate/up (the rest planar)
MOE = dict(n_embd=256, n_ff=256, n_layer=3, moe=True, dense_lead=1, n_expert_shared=2)


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


def _fields(c):
    return {k: v for k, v in dataclasses.asdict(c).items() if k != "raw_kv"}


def _build(path, arch="deepseek2", yarn=False, **kw):
    """build_deepseek2_gguf (seed 7) with DeepSeek-V2-Lite's YaRN keys added
    as build_deepseek2_gguf adds its own keys (it writes none of these)."""
    write = GGUFWriter.write

    def write_yarn(self):
        for k, v in YARN.items():
            key = f"{arch}.{k}"
            if isinstance(v, str):
                self.add_string(key, v)
            elif isinstance(v, int):
                self.add_uint32(key, v)
            else:
                self.add_float32(key, v)
        return write(self)

    with pytest.MonkeyPatch.context() as mp:
        if yarn:
            mp.setattr(GGUFWriter, "write", write_yarn)
        return build_deepseek2_gguf(path, arch, **{"seed": 7, **kw})


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{(layout, yarn): path} of the MoE model, built once each."""
    d = tmp_path_factory.mktemp("mla")
    out = {}
    for layout in ("split", "legacy"):
        for yarn in (False, True):
            out[layout, yarn] = _build(str(d / f"{layout}_{yarn}.gguf"), yarn=yarn,
                                       split_mla=layout == "split", **MOE)
    return out


_JAX_RUNS = {}


def _jax_run(path, kv):
    """The JAX engine's result on PROMPTS (f32 compute), once a file and
    cache type."""
    key = (path, kv)
    if key not in _JAX_RUNS:
        jcfg, jparams, _ = jload(path)
        eng = JEngine(jcfg, jparams, max_seq_len=64, compute_dtype=jnp.float32,
                      kv_dtype={"f32": jnp.float32, "q8": "q8"}[kv], decode_chunk=4)
        _JAX_RUNS[key] = (jcfg, jparams,
                          eng.generate(PROMPTS, max_new_tokens=8, return_logits=True))
    return _JAX_RUNS[key]


# ------------------------------------------------------ config and the cache

@pytest.mark.parametrize("layout", ["split", "legacy"])
@pytest.mark.parametrize("q_lora", [0, 64])
def test_config_and_cache_match_jax(tmp_path, q_lora, layout):
    """Both GGUF conventions give the JAX ModelConfig (the split one: one kv
    head, key/value_length the compressed row, the *_mla keys the per-head
    dims; the legacy one: n_head kv heads and the per-head dims), and the
    cache is JAX's in bf16, f32 and int8: one head of [c_kv; k_pe] and c_kv,
    with row scales on int8; nbytes counts every bank."""
    path = _build(str(tmp_path / "m.gguf"), q_lora=q_lora, split_mla=layout == "split")
    jcfg, _, _ = jload(path)
    cfg, params, _ = load_model(path, device="cpu")
    assert _fields(cfg) == _fields(jcfg)
    assert (cfg.kv_lora_rank, cfg.q_lora_rank, cfg.head_dim, cfg.head_dim_v) == (
        64, q_lora, 64, 32)
    assert cfg.n_head_kv == (1 if layout == "split" else 4)
    assert ("wq_a" in params["layers"]) == bool(q_lora) != ("wq" in params["layers"])
    for jdt, dt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32),
                    ("q8", "q8")):
        jc, c = JKVCache.create(jcfg, 2, 32, jdt), KVCache.create(cfg, 2, 32, dt, "cpu")
        assert c.k.shape == jc.k.shape == (2, 2, 1, 32, 80)
        assert c.v.shape == jc.v.shape == (2, 2, 1, 32, 64)
        assert c.quantized == jc.quantized == (dt == "q8")
        if c.quantized:
            assert c.ks.shape == jc.ks.shape and c.vs.shape == jc.vs.shape
        assert c.nbytes == sum(np.asarray(t).nbytes for t in (jc.k, jc.v, jc.ks, jc.vs)
                               if t is not None)


@pytest.mark.parametrize("layout", ["split", "legacy"])
def test_absorption_banks_match_jax(files, layout):
    """The loader's wk_b (L, H, kv_lora, nope) and wv_b (L, H, v, kv_lora),
    dense f32, equal the JAX _mla_prepare's within 1e-7 in each layer group;
    the legacy attn_kv_b (Q8_0) is split at load."""
    path = files[layout, False]
    _, jparams, _ = jload(path)
    cfg, params, _ = load_model(path, device="cpu")
    jgroups = jparams["layers"]["__groups__"]
    for gl, jgl in zip(params["layers"]["__groups__"], jgroups):
        assert "wkv_b" not in gl
        for k, shape in (("wk_b", (4, 64, 48)), ("wv_b", (4, 32, 64))):
            assert gl[k].dtype == torch.float32 and tuple(gl[k].shape[1:]) == shape
            np.testing.assert_allclose(gl[k].numpy(), np.asarray(jgl[k]), rtol=0, atol=1e-7)


# ------------------------------------------------------- the model against JAX

@pytest.mark.parametrize("kv", ["f32", "q8"])
@pytest.mark.parametrize("yarn", [False, True])
@pytest.mark.parametrize("layout", ["split", "legacy"])
def test_moe_generate_matches_jax(files, layout, yarn, kv):
    """The MLA MoE model through the port's loader against the JAX engine:
    first-step logits at NMSE < 1e-6 and identical greedy tokens (both sides
    the plain f32 path), the dense lead a layer group of its own, the shared
    experts (expert_shared_count 2) one FFN of twice the expert width. With
    YaRN the attention scale takes mscale^2 and the logits move."""
    path = files[layout, yarn]
    jcfg, _, jr = _jax_run(path, kv)
    cfg, params, _ = load_model(path, device="cpu")
    assert _fields(cfg) == _fields(jcfg)
    assert (cfg.n_expert_shared, cfg.n_layer_dense_lead, cfg.rope_scaling) == (
        2, 1, "yarn" if yarn else "none")
    dense, moe = params["layers"]["__groups__"]
    assert moe["ffn_gate_shexp"].shape == (2, 128, 256) and "moe_gate_exps" not in dense
    assert dense["wkv_a"].layout == moe["moe_gate_exps"].layout == "kmajor"
    if yarn:
        assert abs(mla_scale(cfg) - 1.2608 ** 2 / 8.0) < 1e-3
    r = InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                        kv_dtype={"f32": torch.float32, "q8": "q8"}[kv], decode_chunk=4,
                        device="cpu").generate(PROMPTS, max_new_tokens=8, return_logits=True)
    nmse = _nmse(r.logits, jr.logits)
    assert nmse < 1e-6, nmse
    assert r.tokens == jr.tokens
    if yarn:
        _, _, jr_plain = _jax_run(files[layout, False], kv)
        assert _nmse(r.logits, jr_plain.logits) > 1e-6


@pytest.mark.parametrize("layout", ["split", "legacy"])
def test_params_from_numpy_matches_jax(files, layout):
    """The JAX params carried across (wq_a, q_a_norm, wq_b, wkv_a, kv_a_norm,
    wk_b, wv_b among them) run as the JAX engine does: NMSE < 1e-6 on the
    first-step logits, identical greedy tokens, f32 and int8 caches."""
    for kv in ("f32", "q8"):
        jcfg, jparams, jr = _jax_run(files[layout, True], kv)
        cfg, params = params_from_numpy(dataclasses.asdict(jcfg), _flatten(jparams),
                                        device="cpu")
        lead = params["layers"]["__groups__"][0]
        for k in ("wq_a", "q_a_norm", "wq_b", "wkv_a", "kv_a_norm", "wk_b", "wv_b"):
            assert k in lead, k
        r = InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                            kv_dtype={"f32": torch.float32, "q8": "q8"}[kv], decode_chunk=4,
                            device="cpu").generate(PROMPTS, max_new_tokens=8,
                                                   return_logits=True)
        assert _nmse(r.logits, jr.logits) < 1e-6
        assert r.tokens == jr.tokens


BURST = [list(range(3, 13)), list(range(40, 52)), [9, 8, 7, 6, 5, 4, 3, 2]]
PAIR = [101, 7, 55, 3, 81, 200]


def _run_server(ctx, task_cls, params_cls, n_new=6):
    """A burst of three greedy requests on two slots, then a sequential pair
    whose second prompt extends the first and its completion. -> [(tokens,
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


@pytest.mark.parametrize("kv", ["q8", "f32"])
def test_server_context_matches_jax(files, kv):
    """Identical greedy tokens and prefix reuse from the port's and the JAX
    package's ServerContext on the split YaRN file (token ids, f32 compute,
    2 slots, decode chunks of 4, prefill chunks of 8)."""
    path = files["split", True]
    jcfg, jparams, _ = jload(path)
    cfg, params, _ = load_model(path, device="cpu")
    common = dict(n_slots=2, max_seq_len=64, decode_chunk=4, prefill_chunk=8)
    jctx = JServerContext(jcfg, jparams, None, compute_dtype=jnp.float32,
                          kv_dtype={"f32": jnp.float32, "q8": "q8"}[kv], **common)
    tctx = ServerContext(cfg, params, None, compute_dtype=torch.float32,
                         kv_dtype={"f32": torch.float32, "q8": "q8"}[kv], device="cpu",
                         **common)
    want = _run_server(jctx, JTask, JGenParams)
    got = _run_server(tctx, Task, GenParams)
    assert got == want
    assert all(len(toks) == 6 for toks, _ in got)


@pytest.mark.parametrize("kv", [torch.float32, "q8"])
def test_incremental_decode_equals_full_prefill(files, kv):
    """Token by token through the compressed cache (each step's new row
    written by the store, attention over every row so far) gives the
    logits a prefill of the whole sequence gives at each position."""
    cfg, params, _ = load_model(files["split", True], device="cpu")
    seq = PROMPTS[2]
    T = len(seq)
    tok = torch.tensor([seq])
    pos = torch.arange(T)[None]
    vf = torch.zeros(1, dtype=torch.int64)
    full, _ = forward(params, cfg, tok, pos, KVCache.create(cfg, 1, 32, kv, "cpu"), 0, vf,
                      torch.float32)
    cache = KVCache.create(cfg, 1, 32, kv, "cpu")
    lg, _ = forward(params, cfg, tok[:, :4], pos[:, :4], cache, 0, vf, torch.float32)
    steps = [lg[:, -1]]
    for t in range(4, T):
        lg, _ = forward(params, cfg, tok[:, t:t + 1], pos[:, t:t + 1], cache, t, vf,
                        torch.float32, kv_view_len=32)
        steps.append(lg[:, -1])
    inc = torch.stack(steps, 1)
    assert _nmse(inc.numpy(), full[:, 3:].numpy()) < 1e-10


# ------------------------------------------------------------- the routes

def test_mla_attention_takes_einsum_and_no_layer_kernel(files, monkeypatch):
    """Every MLA attention call brings its own scale (mla_scale), and a
    scaled call takes the einsum path on the card whatever its dims, as the
    JAX prefill gate wants ``scale is None`` (llama.py:268): also at a width
    where kv_lora + rope is a multiple of 128 and the rest of the gate holds
    (where an unscaled call takes kernel C). The layer kernel's gate refuses
    MLA layers, as the JAX gate's ``kv_lora_rank == 0`` does (llama.py:1395),
    on both layer groups and at decode shapes."""
    calls = []
    real = llama.attention_route

    def spy(*a):
        calls.append(a[10] if len(a) > 10 else False)  # scaled
        return real(*a)

    monkeypatch.setattr(llama, "attention_route", spy)
    cfg, params, _ = load_model(files["split", True], device="cpu")
    cache = KVCache.create(cfg, 1, 32, torch.float32, "cpu")
    tok = torch.tensor([PROMPTS[0]])
    forward(params, cfg, tok, torch.arange(5)[None], cache, 0, torch.zeros(1, dtype=torch.int64),
            torch.float32)
    assert calls == [True] * cfg.n_layer
    # kv_lora 64 + rope 64: Dk 128; the shapes kernel C builds (Dk = Dv)
    args = (True, 1, 128, 256, 128, 128, 16, 1, torch.bfloat16)
    assert real(*args) == "flash_attention"
    assert real(*args, scaled=True) == "einsum"
    wide = dataclasses.replace(cfg, kv_lora_rank=64, rope_dim=64, head_dim=192)
    assert llama.decode_route(wide, 4, 256, torch.bfloat16, True) == "einsum"
    for gl in params["layers"]["__groups__"]:
        qw = {k: v for k, v in gl.items() if hasattr(v, "qtype")}
        assert layer_routes(cfg, gl, qw, 1, 1, True, 2) == (False, False)


# ------------------------------------------------------------- the shift

def _mla_cache(kv, seed=3):
    """A random MLA cache of 2 layers, 3 slots, 48 slots of [c_kv 64; k_pe
    16] and c_kv 64."""
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.standard_normal((2, 3, 1, 48, 80)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 3, 1, 48, 64)).astype(np.float32))
    if kv == "q8":
        (kq, ks), (vq, vs) = _kv_quant(k), _kv_quant(v)
        return KVCache(kq, vq, ks, vs), k, v
    return KVCache(k.to(kv), v.to(kv)), k, v


MLA_CFG = dict(arch="deepseek2", n_layer=2, n_head=4, n_head_kv=1, head_dim=64, head_dim_v=32,
               rope_dim=16, rope_type="neox", kv_lora_rank=64, q_lora_rank=64)


@pytest.mark.parametrize("kv", [torch.float32, torch.bfloat16, "q8"])
@pytest.mark.parametrize("yarn", [False, True])
def test_shift_rotates_only_the_kpe_tail(kv, yarn):
    """The port's shift of an MLA cache moves every row of the slot; of the
    moved rows it rotates only K's last rope_dim dims (k_pe) by the pure
    rotation at -n_discard (no YaRN mscale on top: the stored k_pe keeps the
    magnitude its write gave it), and moves c_kv (K's head and V) bit for
    bit, V's row scales too; other slots do not change."""
    yf = dict(rope_scaling="yarn", rope_scale=40.0, rope_orig_ctx=4096,
              rope_yarn_log_mul=0.707) if yarn else {}
    cfg = ModelConfig(**MLA_CFG, **yf)
    cache, k, v = _mla_cache(kv)
    old = [None if t is None else t.clone() for t in (cache.k, cache.v, cache.ks, cache.vs)]
    slot, n_keep, nd, n_past = 1, 4, 10, 40
    _context_shift(cache, cfg, slot, n_keep, nd, n_past)
    ok, ov, oks, ovs = old
    mv, src = slice(n_keep, n_past - nd), slice(n_keep + nd, n_past)
    assert torch.equal(cache.v[:, slot, :, mv], ov[:, slot, :, src])
    assert torch.equal(cache.v[:, slot, :, :n_keep], ov[:, slot, :, :n_keep])
    if kv == "q8":
        assert torch.equal(cache.vs[:, slot, :, mv], ovs[:, slot, :, src])
        assert torch.equal(cache.k[:, slot, :, :n_keep], ok[:, slot, :, :n_keep])
        kf = cache.k.float() * cache.ks[..., None]
        was = (ok.float() * oks[..., None])[:, slot, :, src]
        tol = float(cache.ks.max()) * 0.51  # half a step of the requantized rows
    else:
        assert torch.equal(cache.k[:, slot, :, mv, :64], ok[:, slot, :, src, :64])
        assert torch.equal(cache.k[:, slot, :, :n_keep], ok[:, slot, :, :n_keep])
        kf, was, tol = cache.k.float(), ok.float()[:, slot, :, src], (
            0.0 if kv == torch.float32 else 2e-2)
    theta, _ = rope_angles(cfg, torch.full((1, 1), -nd, dtype=torch.float32))
    L, S = was.shape[0], was.shape[2]
    cos, sin = (f(theta).expand(L, S, 8) for f in (torch.cos, torch.sin))
    want = apply_rope(was[..., 64:].transpose(1, 2), cos, sin, "neox", 16).transpose(1, 2)
    got = kf[:, slot, :, mv]
    assert float((got[..., 64:] - want).abs().max()) <= max(tol, 1e-6)
    assert float((got[..., :64] - was[..., :64]).abs().max()) <= max(tol, 0.0)
    # the rotation is pure: each pair's norm is kept
    n_was = was[..., 64:].reshape(L, 1, S, 2, 8).pow(2).sum(-2)
    n_got = got[..., 64:].reshape(L, 1, S, 2, 8).pow(2).sum(-2)
    if kv == torch.float32:
        torch.testing.assert_close(n_got, n_was, rtol=1e-5, atol=1e-6)
    for other in (0, 2):
        assert torch.equal(cache.k[:, other], ok[:, other])
        assert torch.equal(cache.v[:, other], ov[:, other])


def test_jax_shift_rotates_the_latent_head():
    """The JAX package's shift rotates the first rope_dim dims of each moved
    K row (memory.py:301-311), which in the MLA cache are c_kv's, and leaves
    the k_pe tail as it was: pinned here as it computes (ROADMAP §3)."""
    jcfg = JConfig(**MLA_CFG)
    _, k, v = _mla_cache(torch.float32)
    slot, n_keep, nd, n_past = 1, 4, 10, 40
    jk, jv = jnp.asarray(k.numpy()), jnp.asarray(v.numpy())
    jnew = j_context_shift(JKVCache(jk, jv), jnp.int32(slot), jnp.int32(n_keep), jnp.int32(nd),
                           jnp.int32(n_past), cfg=jcfg)
    moved = np.asarray(jnew.k[:, slot, :, n_keep:n_past - nd]).astype(np.float32)
    was = k.numpy()[:, slot, :, n_keep + nd:n_past].astype(
        jnp.bfloat16).astype(np.float32)  # the JAX shift rounds K to bf16
    assert np.abs(moved[..., :16] - was[..., :16]).max() > 0.1  # c_kv's head rotated
    np.testing.assert_array_equal(moved[..., 64:], was[..., 64:])  # k_pe not rotated
    np.testing.assert_array_equal(np.asarray(jnew.v[:, slot, :, n_keep:n_past - nd]),
                                  v.numpy()[:, slot, :, n_keep + nd:n_past])


@pytest.mark.parametrize("kv", [torch.float32, "q8"])
@pytest.mark.parametrize("yarn", [False, True])
def test_shift_decodes_as_reprefill(tmp_path, kv, yarn):
    """The oracle of the MLA shift: on a 1-layer model (its K and V rows
    depend on their token and position alone) a slot prefilled with 30
    tokens and shifted (keep 4, discard 9) decodes the next token as a slot
    prefilled with the 21 kept tokens at their new positions does: NMSE <
    1e-6 in f32 (the int8 cache within its own rounding), and the two
    caches' rows agree."""
    path = _build(str(tmp_path / "one.gguf"), yarn=yarn, split_mla=True, n_layer=1)
    cfg, params, _ = load_model(path, device="cpu")
    rng = np.random.default_rng(5)
    seq = rng.integers(0, cfg.vocab_size, 30).tolist()
    n_keep, nd = 4, 9
    kept = seq[:n_keep] + seq[n_keep + nd:]
    vf = torch.zeros(1, dtype=torch.int64)

    def prefill(mem, toks):
        forward(params, cfg, torch.tensor([toks]), torch.arange(len(toks))[None], mem.cache, 0,
                vf, torch.float32, slot0=0)
        mem.slots[0].n_past, mem.slots[0].tokens = len(toks), list(toks)

    def step(mem, tok):
        n = mem.slots[0].n_past
        lg, _ = forward(params, cfg, torch.tensor([[tok]]), torch.tensor([[n]]), mem.cache,
                        torch.tensor([n]), vf, torch.float32, kv_view_len=64, slot0=0)
        return lg[0, -1].numpy()

    shifted = SlotMemory(cfg, 1, 64, kv, "cpu")
    prefill(shifted, seq)
    shifted.context_shift(0, n_keep, nd)
    assert shifted.slots[0].tokens == kept
    fresh = SlotMemory(cfg, 1, 64, kv, "cpu")
    prefill(fresh, kept)
    n = len(kept)
    if kv == "q8":
        a = shifted.cache.k.float() * shifted.cache.ks[..., None]
        b = fresh.cache.k.float() * fresh.cache.ks[..., None]
        assert float((a[..., :n, :] - b[..., :n, :]).abs().max()) < 2 * float(
            fresh.cache.ks.max())
    else:
        for a, b in ((shifted.cache.k, fresh.cache.k), (shifted.cache.v, fresh.cache.v)):
            torch.testing.assert_close(a[..., :n, :], b[..., :n, :], rtol=1e-5, atol=1e-5)
    got, want = step(shifted, 11), step(fresh, 11)
    assert _nmse(got, want) < (1e-6 if kv == torch.float32 else 1e-3), _nmse(got, want)


# ------------------------------------------------------------- the gate

@pytest.mark.parametrize("field,value", [
    ("sliding_window", 4096), ("attn_bias", True), ("residual_scale", 0.5),
    ("attn_logit_softcap", 50.0), ("post_norms", True), ("use_rope", False),
    ("attn_scale", 0.1), ("parallel_residual", True)])
def test_check_dense_refuses_what_mla_does_not_read(field, value):
    """The MLA fields pass check_dense, on the dense path and beside MoE
    tensors; a flag the MLA layer does not read raises beside them (the JAX
    layer's MLA branch, llama.py:1159-1174, would drop it)."""
    from tpullm_torch.models.llama import check_dense

    cfg = ModelConfig(**MLA_CFG, rope_scaling="yarn", rope_scale=40.0, rope_orig_ctx=4096,
                      rope_yarn_log_mul=0.707)
    check_dense(cfg)
    check_dense(dataclasses.replace(cfg, n_expert=8, n_expert_used=2, n_expert_shared=2),
                moe=True)
    with pytest.raises(NotImplementedError, match=field):
        check_dense(dataclasses.replace(cfg, **{field: value}))


def test_moe_fields_without_experts():
    """Without MoE tensors the MoE fields that describe no expert pass, as
    the JAX graph reads none of them there: the router's gating (glm-dsa's
    row sets sigmoid), the expert width of a config with no experts and a
    dense lead over every layer (the deepseek2 family's dense files carry
    both); the shared experts' count, a shorter dense lead and the expert
    width beside experts still raise there."""
    from tpullm_torch.models.llama import check_dense

    check_dense(ModelConfig(expert_gating="sigmoid"))
    check_dense(ModelConfig(n_ff_exp=128))
    check_dense(ModelConfig(n_layer=2, n_layer_dense_lead=2))
    for bad in (dict(n_expert_shared=2), dict(n_layer=2, n_layer_dense_lead=1),
                dict(n_expert=4, n_ff_exp=128)):
        with pytest.raises(NotImplementedError, match=next(iter(bad)) if len(bad) == 1
                           else "n_layer_dense_lead|n_expert"):
            check_dense(ModelConfig(**bad))


# ------------------------------------------------------------- the synth

@pytest.mark.parametrize("q_lora", [0, 64])
def test_synth_mla_matches_decompressed_mha(q_lora):
    """synth_mla_q4k (a dense lead, then MoE layers with a shared expert;
    YaRN) runs through forward; its first layer's attention in the absorbed
    form equals plain multi-head attention over K and V decompressed from
    the cached latent (k_nope = wk_b c_kv, v = wv_b c_kv per head, k_pe
    shared) at mla_scale: the MLA algebra checked without the JAX package.
    Each weight takes the type and layout a Q4_K_M file and the loader give
    it (Q8_0 planar where K is not a multiple of 256)."""
    from tpullm_torch.models.llama import ffn, qmm, rms_norm, rope_cache
    from tpullm_torch.ops.flash_attention import masked_attention
    from tpullm_torch.utils.synth import synth_mla_q4k

    cfg, params = synth_mla_q4k(
        vocab_size=300, n_embd=512, n_layer=3, n_head=4, kv_lora_rank=64, qk_nope=48,
        qk_rope=16, v_head=32, n_ff=288, q_lora_rank=q_lora, n_expert=8, n_expert_used=2,
        n_ff_exp=96, n_ff_shexp=192, n_expert_shared=2, n_dense_lead=1, device="cpu", seed=4,
        cfg_fields=dict(rope_scaling="yarn", rope_scale=40.0, rope_orig_ctx=4096,
                        rope_yarn_log_mul=0.707))
    dense, moe = params["layers"]["__groups__"]
    assert (cfg.kv_lora_rank, cfg.head_dim, cfg.head_dim_v, cfg.n_head_kv) == (64, 64, 32, 1)
    assert (cfg.n_expert_shared, cfg.n_layer_dense_lead) == (2, 1)
    lay = {k: (v.qtype.name, v.layout) for k, v in moe.items() if hasattr(v, "qtype")}
    assert lay["moe_gate_exps"] == ("Q4_K", "kmajor") and lay["wkv_a"] == ("Q4_K", "kmajor")
    assert lay["moe_down_exps"] == lay["ffn_down_shexp"] == ("Q8_0", "planar")
    assert dense["ffn_gateup"].layout == "kmajor" and ("wq_a" in dense) == bool(q_lora)
    T = 9
    tok = torch.arange(3, 3 + T)[None]
    pos = torch.arange(T)[None]
    cache = KVCache.create(cfg, 1, 16, torch.float32, "cpu")
    vf = torch.zeros(1, dtype=torch.int64)
    logits, _ = forward(params, cfg, tok, pos, cache, 0, vf, torch.float32)
    assert torch.isfinite(logits).all() and logits.shape == (1, T, 300)
    # the first layer by hand, its K and V decompressed
    lw = {k: v[0] if not hasattr(v, "qtype") else v for k, v in dense.items()}
    x = params["tok_embd"].take_rows(tok, torch.float32)
    h = rms_norm(x, lw["attn_norm"], cfg.rms_eps)
    if q_lora:
        ql = rms_norm(qmm(h, dense["wq_a"], torch.float32, 0), lw["q_a_norm"], cfg.rms_eps)
        q = qmm(ql, dense["wq_b"], torch.float32, 0)
    else:
        q = qmm(h, dense["wq"], torch.float32, 0)
    q = q.reshape(1, T, 4, 64)
    kvp = qmm(h, dense["wkv_a"], torch.float32, 0)
    c_kv = rms_norm(kvp[..., :64], lw["kv_a_norm"], cfg.rms_eps)
    cos, sin = rope_cache(cfg, pos)
    q_pe = apply_rope(q[..., 48:], cos, sin, "neox", 16)
    k_pe = apply_rope(kvp[..., 64:80].reshape(1, T, 1, 16), cos, sin, "neox", 16)
    k_nope = torch.einsum("tl,hln->thn", c_kv[0], lw["wk_b"])
    v = torch.einsum("tl,hvl->thv", c_kv[0], lw["wv_b"])
    k = torch.cat([k_nope, k_pe[0].expand(T, 4, 16)], -1)  # (T, H, 64)
    qf = torch.cat([q[..., :48], q_pe], -1)
    kv_pos = torch.arange(T)[None]
    att = masked_attention(qf, k.transpose(0, 1)[None], v.transpose(0, 1)[None], pos, kv_pos,
                           pos, vf, mla_scale(cfg))
    x1 = x + qmm(att.reshape(1, T, 128), dense["wo"], torch.float32, 0)
    x1 = x1 + ffn(rms_norm(x1, lw["ffn_norm"], cfg.rms_eps), dense, 0, cfg, torch.float32)
    one = dataclasses.replace(cfg, n_layer=1, n_expert=0, n_expert_used=0, n_ff_exp=0,
                              n_layer_dense_lead=0, n_expert_shared=0)
    p1 = dict(params, layers=dense)
    got, _ = forward(p1, one, tok, pos, KVCache.create(one, 1, 16, torch.float32, "cpu"), 0,
                     vf, torch.float32)
    want = qmm(rms_norm(x1, params["output_norm"], cfg.rms_eps), params["output"],
               torch.float32)
    assert _nmse(got.numpy(), want.numpy()) < 1e-10
