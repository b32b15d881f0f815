"""Per-layer sliding-window arrays, the GGUF-combined [gate; up] FFN and
step35's per-head attention gate in the port, held against the JAX package
on the CPU: the SWA pattern as a 0/1 array (exaone4's published LLLG against
its scalar period of 4, step35's aperiodic (1, 0, 1, 1)) through the parser,
the flags, the windows, the dual cache's banks, the engine and a
ServerContext on the ring and on the full cache; the combined ffn_up (phi3,
chatglm, plamo3) byte for byte against the fused layout where n_ff is a
multiple of 256 and split where it is not, phi3 files at K-major widths
through the loader and the carried-across params against the JAX engine,
and the layer kernel's route for it (the port's own); step35's gate against
the JAX forward, and live.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_gateup_swa.py -q
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGMLType
from tpullm.models.config import config_from_gguf as jconfig_from_gguf
from tpullm.models.llama import KVCache as JKVCache
from tpullm.models.llama import swa_flags as jswa_flags
from tpullm.ops.layer_kernel import supported as jblock_supported
from tpullm.ops.qtensor import QTensor as JQTensor
from tpullm.runtime.engine import InferenceEngine as JEngine
from tpullm.runtime.loader import load_model as jload
from tpullm.server.context import GenParams as JGenParams
from tpullm.server.context import ServerContext as JServerContext
from tpullm.server.context import Task as JTask
from tpullm.utils import synth as jsynth
from tpullm.utils.synth import build_arch_gguf, build_llama_gguf
from tpullm_torch.gguf.reader import GGUFFile
from tpullm_torch.models.config import config_from_gguf
from tpullm_torch.models.llama import (KVCache, bank_map, forward, layer_routes, layer_windows,
                                       swa_flags)
from tpullm_torch.ops.fuse import concat_kmajor, fuse_layer_weights
from tpullm_torch.ops.qtensor import QTensor, qtensor_from_bytes
from tpullm_torch.runtime.engine import InferenceEngine
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.server.context import GenParams, ServerContext, Task
from tpullm_torch.utils.from_jax import params_from_numpy

torch.set_num_threads(2)

WINDOW = 32  # build_arch_gguf's window for an SWA array or a (window, period) hint
CHUNK = 32
_rng = np.random.default_rng(31)
# past the window: the 70-token prompt wraps a 64-slot ring in its prefill
PROMPTS = [_rng.integers(1, 250, n).tolist() for n in (70, 45, 9)]


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


def _kmajor_gguf(path, arch, monkeypatch, hints=None, n_layer=4, n_ff=512,
                 qtype=GGMLType.Q4_K):
    """``arch`` at K-major widths (head dim 128), with its SYNTH_HINTS
    replaced by ``hints`` where given (the weights draw as before: hints
    that write keys only, or the combined ffn_up of phi3's file)."""
    if hints is not None:
        monkeypatch.setitem(jsynth.SYNTH_HINTS, arch, hints)
    return build_arch_gguf(str(path), arch, n_embd=512, n_layer=n_layer, n_head=4,
                           n_head_kv=2, n_ff=n_ff, qtype=qtype, seed=11)


# ------------------------------------------------------------- the SWA array

@pytest.mark.parametrize("arch,hints,flags", [
    ("exaone4", dict(swa_layers=(1, 1, 1, 0)), [True, True, True, False]),
    ("step35", None, [True, False, True, True])])
def test_swa_array_parses_as_jax(tmp_path, monkeypatch, arch, hints, flags):
    """An attention.sliding_window_pattern array (exaone4's published LLLG,
    step35's synth hint (1, 0, 1, 1)) gives the JAX parser's config: the
    flags in swa_layer_pattern, swa_pattern 2 as the "any SWA" marker; the
    port's swa_flags read them as the JAX ones, layer_windows windows the
    flagged layers, and the dual cache has the JAX banks, the flagged layers
    indexing the ring banks in layer order (bank_map)."""
    path = _kmajor_gguf(tmp_path / f"{arch}.gguf", arch, monkeypatch, hints)
    cfg = config_from_gguf(GGUFFile(path))
    from tpullm.gguf.reader import GGUFFile as JGGUFFile

    jcfg = jconfig_from_gguf(JGGUFFile(path))
    assert _fields(cfg) == _fields(jcfg)
    assert cfg.swa_layer_pattern == tuple(flags) and cfg.swa_pattern == 2
    assert cfg.sliding_window == WINDOW
    assert swa_flags(cfg) == jswa_flags(jcfg) == flags
    assert layer_windows(cfg) == [WINDOW if f else 0 for f in flags]
    dual = KVCache.create(cfg, 2, 256, torch.bfloat16, "cpu", iswa=True, max_chunk=CHUNK)
    jdual = JKVCache.create(jcfg, 2, 256, jnp.bfloat16, iswa=True, max_chunk=CHUNK)
    assert {n: tuple(getattr(dual, n).shape) for n in ("k", "v", "kw", "vw")} == {
        n: tuple(getattr(jdual, n).shape) for n in ("k", "v", "kw", "vw")}
    assert dual.ring == jdual.ring == WINDOW + CHUNK
    ring_i, full_i = iter(range(4)), iter(range(4))
    assert bank_map(cfg, True) == [(f, next(ring_i if f else full_i)) for f in flags]


def test_swa_array_shorter_than_layers_raises(tmp_path, monkeypatch):
    """An array with fewer flags than layers raises at parse (a layer would
    have no flag)."""
    path = _kmajor_gguf(tmp_path / "e.gguf", "exaone4", monkeypatch, dict(swa_layers=(1, 0)))
    with pytest.raises(ValueError, match="2 flags for 4 layers"):
        config_from_gguf(GGUFFile(path))


@pytest.fixture(scope="module")
def exaone4_pair(tmp_path_factory):
    """exaone4 at K-major widths, 4 layers, window 32: one file with the
    published array (1, 1, 1, 0), one with the scalar period 4; the same
    weights."""
    d = tmp_path_factory.mktemp("exaone4")
    mp = pytest.MonkeyPatch()
    try:
        arr = _kmajor_gguf(d / "arr.gguf", "exaone4", mp, dict(swa_layers=(1, 1, 1, 0)))
        per = _kmajor_gguf(d / "per.gguf", "exaone4", mp, dict(swa=(WINDOW, 4)))
    finally:
        mp.undo()
    return arr, per


def test_exaone4_array_equals_scalar_period(exaone4_pair):
    """exaone4's published array gives the scalar period's flags, windows,
    banks and logits (f32, prompts past the window, on the full cache and on
    the ring, bit for bit), and the JAX engine's logits on the array file."""
    arr, per = exaone4_pair
    (ca, pa, _), (cp, pp, _) = load_model(arr, device="cpu"), load_model(per, device="cpu")
    assert (ca.swa_pattern, cp.swa_pattern, cp.swa_layer_pattern) == (2, 4, ())
    assert swa_flags(ca) == swa_flags(cp) == [True, True, True, False]
    assert layer_windows(ca) == layer_windows(cp)
    assert bank_map(ca, True) == bank_map(cp, True)
    out = {}
    for name, c, p in (("arr", ca, pa), ("per", cp, pp)):
        for iswa in (False, True):
            eng = InferenceEngine(c, p, max_seq_len=256, compute_dtype=torch.float32,
                                  decode_chunk=4, iswa=iswa, prefill_chunk=CHUNK, device="cpu")
            out[name, iswa] = eng.generate(PROMPTS[:2], max_new_tokens=6, return_logits=True)
    for iswa in (False, True):
        assert np.array_equal(out["arr", iswa].logits, out["per", iswa].logits)
        assert out["arr", iswa].tokens == out["per", iswa].tokens
    jcfg, jparams, _ = jload(arr)
    jr = JEngine(jcfg, jparams, max_seq_len=256, compute_dtype=jnp.float32,
                 decode_chunk=4).generate(PROMPTS[:2], max_new_tokens=6, return_logits=True)
    assert _nmse(out["arr", False].logits, jr.logits) < 1e-6
    assert out["arr", False].tokens == jr.tokens


PHI3_SWA = dict(fused_qkv=True, combined_gateup=True, swa_layers=(1, 0, 1, 1))


@pytest.fixture(scope="module")
def phi3_swa(tmp_path_factory):
    """A 4-layer phi3 file at K-major widths with the aperiodic SWA array
    (1, 0, 1, 1), a window of 32, the fused attn_qkv and the combined
    ffn_up: (port cfg, params, JAX cfg, params)."""
    d = tmp_path_factory.mktemp("phi3_swa")
    mp = pytest.MonkeyPatch()
    try:
        path = _kmajor_gguf(d / "phi3.gguf", "phi3", mp, PHI3_SWA)
    finally:
        mp.undo()
    cfg, params, _ = load_model(path, device="cpu")
    jcfg, jparams, _ = jload(path)
    return cfg, params, jcfg, jparams


def _serve(make, task_cls, params_cls, prompts, n_new=10):
    ctx = make()
    ctx.start()
    try:
        tasks = [task_cls(tokens=list(p), params=params_cls(
            max_tokens=n_new, temperature=0.0, ignore_eos=True)) for p in prompts]
        for t in tasks:
            ctx.submit(t)
        outs = []
        for t in tasks:
            done = [p for k, p in t.events() if k == "done"]
            assert done, "task errored"
            outs.append(done[0]["tokens"])
        return outs, ctx
    finally:
        ctx.stop()


@pytest.mark.parametrize("iswa", [True, False], ids=["ring", "full"])
def test_aperiodic_array_server_matches_jax(phi3_swa, iswa):
    """A ServerContext on the (1, 0, 1, 1) array, on the ring (three SWA
    layers in ring banks of window + chunk = 64, the second layer on the
    full banks) and on the full cache: the JAX ServerContext's greedy
    tokens for prompts past the window, three requests on two slots."""
    cfg, params, jcfg, jparams = phi3_swa
    common = dict(n_slots=2, max_seq_len=256, decode_chunk=4, prefill_chunk=CHUNK, iswa=iswa)
    got, ctx = _serve(lambda: ServerContext(cfg, params, None, compute_dtype=torch.float32,
                                            device="cpu", **common), Task, GenParams, PROMPTS)
    want, jctx = _serve(lambda: JServerContext(jcfg, jparams, None, compute_dtype=jnp.float32,
                                               **common), JTask, JGenParams, PROMPTS)
    assert got == want and all(len(t) == 10 for t in got)
    cache = ctx.memory.cache
    assert cache.dual == iswa
    if iswa:
        assert tuple(cache.kw.shape[:1]) == (3,) and tuple(cache.k.shape[:1]) == (1,)
        assert cache.ring == WINDOW + CHUNK == jctx.memory.cache.ring


def test_aperiodic_array_engine_ring_matches_jax(phi3_swa):
    """The iSWA engine on the (1, 0, 1, 1) array against the JAX iSWA
    engine: first-step logits at NMSE < 1e-10, the same greedy tokens."""
    cfg, params, jcfg, jparams = phi3_swa
    eng = InferenceEngine(cfg, params, max_seq_len=256, compute_dtype=torch.float32,
                          decode_chunk=4, iswa=True, prefill_chunk=CHUNK, device="cpu")
    r = eng.generate(PROMPTS, max_new_tokens=12, return_logits=True)
    jr = JEngine(jcfg, jparams, max_seq_len=256, compute_dtype=jnp.float32, decode_chunk=4,
                 iswa=True, prefill_chunk=CHUNK).generate(PROMPTS, max_new_tokens=12,
                                                          return_logits=True)
    assert _nmse(r.logits, jr.logits) < 1e-10
    assert r.tokens == jr.tokens


# ------------------------------------------------------- the combined gate/up

def _raw_rows(path, name):
    """A GGUF tensor's raw rows and its (qtype, numpy shape)."""
    g = GGUFFile(path)
    ti = g.tensors[name]
    shape = ti.np_shape
    return g.tensor_data(name).reshape(shape[0], -1), ti.ggml_type, shape


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0])
def test_combined_gateup_is_the_fused_layout(tmp_path, qtype):
    """Where n_ff is a multiple of 256, a combined ffn_up packed K-major is,
    byte for byte, concat_kmajor of its gate and up halves packed apart (the
    layout fuse_layer_weights gives separate gate/up)."""
    n_ff = 512
    path = build_llama_gguf(str(tmp_path / "c.gguf"), arch="phi3", vocab_size=256, n_embd=512,
                            n_layer=1, n_head=4, n_head_kv=2, n_ff=n_ff, qtype=qtype, seed=4,
                            fused_qkv=True, combined_gateup=True)
    raw, qt, shape = _raw_rows(path, "blk.0.ffn_up.weight")
    assert shape == (2 * n_ff, 512)
    whole = qtensor_from_bytes(raw, qt, shape)
    halves = [qtensor_from_bytes(raw[i * n_ff:(i + 1) * n_ff], qt, (n_ff, 512))
              for i in range(2)]
    fused = concat_kmajor(halves)
    cfg = config_from_gguf(GGUFFile(path))
    assert fuse_layer_weights({"ffn_up": whole}, cfg) == {"ffn_gateup": whole}
    assert fused.shape == whole.shape and set(fused.data) == set(whole.data)
    for k, v in whole.data.items():
        assert v.dtype == fused.data[k].dtype and torch.equal(v, fused.data[k]), k


@pytest.mark.parametrize("n_ff,qtype,name", [(512, GGMLType.Q4_K, "ffn_gateup"),
                                             (384, GGMLType.Q8_0, "ffn_up")])
def test_loader_names_the_combined_gateup(tmp_path, n_ff, qtype, name):
    """The loader renames a combined ffn_up ffn_gateup where n_ff is a
    multiple of 256 and leaves it ffn_up where it is not (chatglm's 13696
    is such a width: its halves do not fall on 256-column boundaries, so
    the FFN takes one product over the combined matrix and splits it)."""
    path = build_llama_gguf(str(tmp_path / "c.gguf"), arch="phi3", vocab_size=256, n_embd=512,
                            n_layer=2, n_head=4, n_head_kv=2, n_ff=n_ff, qtype=qtype, seed=4,
                            fused_qkv=True, combined_gateup=True)
    cfg, params, _ = load_model(path, device="cpu")
    layers = params["layers"]
    assert name in layers and "ffn_gate" not in layers
    assert not ({"ffn_gateup", "ffn_up"} - {name}) & set(layers)
    assert layers[name].shape == (2, 2 * n_ff, 512) and layers[name].layout == "kmajor"
    assert "wqkv_cat" in layers


@pytest.fixture(scope="module")
def phi3_models(tmp_path_factory):
    """{n_ff: (path, JAX cfg, params, result)}: 2-layer phi3 files with the
    fused attn_qkv and the combined ffn_up at K-major widths (Q4_K at n_ff
    512, renamed ffn_gateup; Q8_0 at n_ff 384, split), generated once by
    the JAX engine."""
    d = tmp_path_factory.mktemp("phi3")
    out = {}
    for n_ff, qtype in ((512, GGMLType.Q4_K), (384, GGMLType.Q8_0)):
        path = build_llama_gguf(str(d / f"phi3_{n_ff}.gguf"), arch="phi3", vocab_size=256,
                                n_embd=512, n_layer=2, n_head=4, n_head_kv=2, n_ff=n_ff,
                                qtype=qtype, seed=11, fused_qkv=True, combined_gateup=True)
        jcfg, jparams, _ = jload(path)
        jr = JEngine(jcfg, jparams, max_seq_len=256, compute_dtype=jnp.float32,
                     decode_chunk=4).generate(PROMPTS, max_new_tokens=8, return_logits=True)
        out[n_ff] = (path, jcfg, jparams, jr)
    return out


@pytest.mark.parametrize("via", ["loader", "params_from_numpy"])
@pytest.mark.parametrize("n_ff", [512, 384])
def test_phi3_combined_gateup_matches_jax(phi3_models, n_ff, via):
    """A phi3 file with the combined ffn_up through the port's loader (or
    the JAX params carried across, which keep the combined ffn_up) and
    engine against the JAX engine: first-step logits at NMSE < 1e-6 and
    the same greedy tokens, the bar of the K-major arch tests."""
    path, jcfg, jparams, jr = phi3_models[n_ff]
    if via == "loader":
        cfg, params, _ = load_model(path, device="cpu")
    else:
        cfg, params = params_from_numpy(dataclasses.asdict(jcfg), _flatten(jparams),
                                        device="cpu")
        assert "ffn_up" in params["layers"]
    assert _fields(cfg) == _fields(jcfg)
    r = InferenceEngine(cfg, params, max_seq_len=256, compute_dtype=torch.float32,
                        decode_chunk=4, device="cpu").generate(
        PROMPTS, max_new_tokens=8, return_logits=True)
    assert _nmse(r.logits, jr.logits) < 1e-6
    assert r.tokens == jr.tokens


def test_combined_gateup_takes_the_layer_kernel_on_the_port_route(phi3_models):
    """The port's own route: the loader's ffn_gateup puts a phi3 decode
    layer (B = 4, T = 1, on the card) on the layer kernel, unfolded (the
    fused attn_qkv is not the load-time wqkv); the JAX gate, on the JAX
    params of the same file (the combined ffn_up kept), keeps it off
    (layer_kernel.py:411); at n_ff 384 neither takes it."""
    for n_ff, want in ((512, (True, False)), (384, (False, False))):
        path, jcfg, jparams, _ = phi3_models[n_ff]
        cfg, params, _ = load_model(path, device="cpu")
        gl = params["layers"]
        qw = {k: v for k, v in gl.items() if isinstance(v, QTensor)}
        assert layer_routes(cfg, gl, qw, 4, 1, True, 1) == want
        assert layer_routes(cfg, gl, qw, 4, 1, False, 1) == (False, False)
        jqw = {k: v for k, v in jparams["layers"].items() if isinstance(v, JQTensor)}
        assert "ffn_gateup" not in jqw and not jblock_supported(jcfg, jqw)


# ------------------------------------------------------------ step35's gate

@pytest.fixture(scope="module")
def step35_model(tmp_path_factory):
    """step35 at K-major widths (Q4_K, 4 layers with its (1, 0, 1, 1)
    array, the per-head gate, MoE with the selection bias and the shared
    expert): (path, JAX cfg, params, result)."""
    d = tmp_path_factory.mktemp("step35")
    path = build_arch_gguf(str(d / "step35.gguf"), "step35", n_embd=512, n_layer=4, n_head=4,
                           n_head_kv=2, n_ff=512, qtype=GGMLType.Q4_K, seed=11)
    jcfg, jparams, _ = jload(path)
    jr = JEngine(jcfg, jparams, max_seq_len=256, compute_dtype=jnp.float32,
                 decode_chunk=4).generate(PROMPTS, max_new_tokens=8, return_logits=True)
    return path, jcfg, jparams, jr


def test_step35_head_gate_matches_jax(step35_model):
    """step35's per-head sigmoid gate on the attention output before wo
    (the JAX forward, llama.py:1231-1245): the port's engine against the
    JAX one at NMSE < 1e-6 with the same greedy tokens; the gate loads as
    wqkv_gate, (L, n_head, n_embd); without it the logits move (the gate is
    live)."""
    path, jcfg, _, jr = step35_model
    cfg, params, _ = load_model(path, device="cpu")
    assert cfg.attn_gate_proj and params["layers"]["wqkv_gate"].shape == (4, 4, 512)
    run = lambda p: InferenceEngine(cfg, p, max_seq_len=256, compute_dtype=torch.float32,
                                    decode_chunk=4, device="cpu").generate(
        PROMPTS, max_new_tokens=8, return_logits=True)
    r = run(params)
    assert _nmse(r.logits, jr.logits) < 1e-6
    assert r.tokens == jr.tokens
    bare = dict(params, layers={k: v for k, v in params["layers"].items() if k != "wqkv_gate"})
    assert _nmse(run(bare).logits, jr.logits) > 1e-4


def test_step35_gate_against_forward_by_hand(step35_model):
    """One prefill through forward against the same forward with the gate
    applied by hand: each head's output times sigmoid(h @ wqkv_gate^T),
    in f32, before wo. The gate's weights scaled to 0 give sigmoid 0.5 on
    every head, which the by-hand run reproduces by halving wo."""
    path = step35_model[0]
    cfg, params, _ = load_model(path, device="cpu")
    layers = params["layers"]
    gate = layers["wqkv_gate"]
    zero = QTensor(gate.qtype, gate.shape, {k: (v * 0 if v.is_floating_point() else v)
                                            for k, v in gate.data.items()})
    tok = torch.tensor([PROMPTS[1][:12]])
    pos = torch.arange(12)[None]
    vf = torch.zeros(1, dtype=torch.int64)

    def run(p):
        cache = KVCache.create(cfg, 1, 32, torch.float32, "cpu")
        return forward(p, cfg, tok, pos, cache, 0, vf, torch.float32)[0]

    wo = layers["wo"]
    half_wo = QTensor(wo.qtype, wo.shape, dict(wo.data))
    for k in ("d", "dmin"):
        if k in half_wo.data:
            half_wo.data[k] = wo.data[k] * 0.5
    ungated = {k: v for k, v in layers.items() if k != "wqkv_gate"}
    got = run(dict(params, layers={**layers, "wqkv_gate": zero}))
    want = run(dict(params, layers={**ungated, "wo": half_wo}))
    assert _nmse(got, want) < 1e-10


def test_synth_gguf_layout():
    """synth_kmajor_q4k_fast(gguf_layout=True), the card runs' Phi-4 weights:
    the fused attn_qkv as wqkv_cat and the combined ffn_up renamed
    ffn_gateup by the loader's fuse step, drawn as the default layout's
    wqkv and ffn_gateup (every part a multiple of 256), so the logits are
    the default layout's bit for bit."""
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    kw = dict(arch="phi3", vocab_size=300, n_embd=512, n_layer=2, n_head=4, n_head_kv=2,
              n_ff=512, seed=5, centred=True, device="cpu", exact_vocab=True)
    cfg, params = synth_kmajor_q4k_fast(gguf_layout=True, **kw)
    _, base = synth_kmajor_q4k_fast(**kw)
    layers = params["layers"]
    assert {"wqkv_cat", "ffn_gateup"} <= set(layers) and not {"wqkv", "ffn_up"} & set(layers)
    assert layers["wqkv_cat"].shape == (2, 1024, 512)
    assert layers["ffn_gateup"].shape == base["layers"]["ffn_gateup"].shape == (2, 1024, 512)
    for k in ("wqkv_cat", "ffn_gateup"):
        b = base["layers"]["wqkv" if k == "wqkv_cat" else k]
        assert all(torch.equal(v, b.data[n]) for n, v in layers[k].data.items()), k
    tok = torch.tensor([PROMPTS[2]])
    pos = torch.arange(len(PROMPTS[2]))[None]
    vf = torch.zeros(1, dtype=torch.int64)
    out = [forward(p, cfg, tok, pos, KVCache.create(cfg, 1, 16, torch.float32, "cpu"), 0, vf,
                   torch.float32)[0] for p in (params, base)]
    assert torch.equal(out[0], out[1])


# ------------------------------------------------- departures from llama.cpp

def test_phi3_window_covers_every_layer(tmp_path, monkeypatch):
    """A phi3 file with attention.sliding_window and no pattern: the JAX
    parser windows every layer (swa_pattern 1), where llama.cpp turns a Phi
    model's window off ("Phi SWA is currently disabled"). The port follows
    the JAX package: every layer's window is 32, the engine's logits for
    prompts past it are the JAX engine's and not those of the same model
    without the window (ROADMAP "Known weak spots of the reference")."""
    from tpullm.gguf.writer import GGUFWriter

    write = GGUFWriter.write

    def write_window(self):
        self.add_uint32("phi3.attention.sliding_window", WINDOW)
        return write(self)

    monkeypatch.setattr(GGUFWriter, "write", write_window)
    path = build_llama_gguf(str(tmp_path / "phi3.gguf"), arch="phi3", vocab_size=256,
                            n_embd=512, n_layer=2, n_head=4, n_head_kv=2, n_ff=512,
                            qtype=GGMLType.Q4_K, seed=11, fused_qkv=True, combined_gateup=True)
    cfg, params, _ = load_model(path, device="cpu")
    jcfg, jparams, _ = jload(path)
    assert (cfg.sliding_window, cfg.swa_pattern) == (jcfg.sliding_window, jcfg.swa_pattern) == (
        WINDOW, 1)
    assert layer_windows(cfg) == [WINDOW, WINDOW]
    run = lambda c: InferenceEngine(c, params, max_seq_len=256, compute_dtype=torch.float32,
                                    decode_chunk=4, device="cpu").generate(
        PROMPTS[:2], max_new_tokens=6, return_logits=True)
    r = run(cfg)
    jr = JEngine(jcfg, jparams, max_seq_len=256, compute_dtype=jnp.float32,
                 decode_chunk=4).generate(PROMPTS[:2], max_new_tokens=6, return_logits=True)
    assert _nmse(r.logits, jr.logits) < 1e-6 and r.tokens == jr.tokens
    assert _nmse(run(dataclasses.replace(cfg, sliding_window=0)).logits, jr.logits) > 1e-6


def test_plamo3_serves_token_ids(tmp_path):
    """plamo3's files carry the PLaMo-2 tokenizer, which the port does not
    run yet (it raises; the JAX package has one): a plamo3 model serves
    token ids, a ServerContext without a tokenizer giving the JAX one's
    greedy tokens."""
    from tpullm_torch.tokenizer import Tokenizer, Vocab

    path = build_arch_gguf(str(tmp_path / "plamo3.gguf"), "plamo3", seed=11)
    cfg, params, _ = load_model(path, device="cpu")
    jcfg, jparams, _ = jload(path)
    common = dict(n_slots=2, max_seq_len=64, decode_chunk=4, prefill_chunk=8)
    prompts = [p[:20] for p in PROMPTS]
    got, _ = _serve(lambda: ServerContext(cfg, params, None, compute_dtype=torch.float32,
                                          device="cpu", **common), Task, GenParams, prompts, 6)
    want, _ = _serve(lambda: JServerContext(jcfg, jparams, None, compute_dtype=jnp.float32,
                                            **common), JTask, JGenParams, prompts, 6)
    assert got == want and all(len(t) == 6 for t in got)
    with pytest.raises(NotImplementedError, match="PLaMo-2"):
        Tokenizer(Vocab(model="plamo2", tokens=["a"]))
