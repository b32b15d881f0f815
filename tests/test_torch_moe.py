"""The port's MoE path held against the JAX package on the CPU: the ragged
bookkeeping, kernel F's plain version against the Pallas kernel in
interpret mode, the ragged and dense MoE FFN, top-k ties, the loader, the
params carried across, the Mixtral arch snapshot and the "llama" arch with
experts. Inputs are drawn with numpy and handed to both packages.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_moe.py -q
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGMLType
from tpullm.models.config import ModelConfig as JConfig
from tpullm.models.llama import moe_ffn as jmoe_ffn
from tpullm.ops.moe_gmm import TM as JTM
from tpullm.ops.moe_gmm import grouped_qmm as jgrouped_qmm
from tpullm.ops.moe_gmm import sort_by_expert as jsort_by_expert
from tpullm.ops.qtensor import QTensor as JQTensor
from tpullm.ops.qtensor import qtensor_from_float
from tpullm.runtime.engine import InferenceEngine as JEngine
from tpullm.runtime.loader import _stack_qtensors
from tpullm.runtime.loader import load_model as jload
from tpullm.utils.synth import build_arch_gguf, build_llama_gguf
from tpullm_torch.models.config import ModelConfig
from tpullm_torch.models.llama import _moe_prefill_ragged, moe_ffn, top_k
from tpullm_torch.ops.moe_gmm import (TM, gmm_supported, grouped_qmm, grouped_qmm_plain,
                                      live_tiles, sort_by_expert)
from tpullm_torch.ops.qtensor import QTensor
from tpullm_torch.runtime.engine import InferenceEngine
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.utils.from_jax import params_from_numpy

torch.set_num_threads(2)

E, USED, D, NFF = 4, 2, 512, 512
SNAP_DIR = os.path.join(os.path.dirname(__file__), "snapshots")
PROMPTS = [[3, 9, 4, 17, 6], [5, 1, 2], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 2, 3, 4, 5,
                                         6, 7, 8, 9, 30]]


def _nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / max((b ** 2).mean(), 1e-30))


def _port(jq):
    """JAX QTensor -> port QTensor (same arrays)."""
    return QTensor(GGMLType(int(jq.qtype)), tuple(jq.shape),
                   {k: torch.from_numpy(np.array(v)) for k, v in jq.data.items()})


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


def _same(port, ref, where=""):
    if isinstance(port, QTensor):
        assert int(port.qtype) == ref["qtype"] and port.shape == ref["shape"], where
        assert set(port.data) == set(ref["data"]), where
        for k, a in ref["data"].items():
            np.testing.assert_array_equal(port.data[k].numpy(), a, err_msg=f"{where}.{k}")
        return
    if isinstance(port, dict):
        assert set(port) == set(ref), (where, sorted(port), sorted(ref))
        for k in ref:
            _same(port[k], ref[k], f"{where}.{k}")
        return
    np.testing.assert_array_equal(port.numpy(), ref, err_msg=where)


# ------------------------------------------------------------ bookkeeping

def _routing(kind, M=64, used=USED, n_expert=E, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return np.stack([rng.permutation(n_expert)[:used] for _ in range(M)]).astype(np.int32)
    if kind == "skewed":  # every assignment to expert 2 (one expert, 2M rows)
        return np.full((M, used), 2, np.int32)
    # "empty": experts 0 and 3 never chosen
    return np.stack([rng.permutation([1, 2])[:used] for _ in range(M)]).astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "skewed", "empty"])
def test_sort_by_expert_matches_jax(kind):
    """At the JAX package's 128-row tile the port's bookkeeping is the JAX
    package's, array for array."""
    top_i = _routing(kind)
    jo, jd, jt, jMp = jsort_by_expert(jnp.asarray(top_i), E, top_i.shape[0])
    o, d, t, Mp = sort_by_expert(torch.from_numpy(top_i), E, top_i.shape[0], tm=JTM)
    assert JTM == 128 and Mp == jMp and Mp % JTM == 0
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    # live tiles: every tile up to the last holding a row, and no further
    used_tiles = set((d.numpy() // JTM).tolist())
    n_live = int(live_tiles(d, t, Mp)[0])
    assert max(used_tiles) == n_live - 1 and n_live <= Mp // JTM


@pytest.mark.parametrize("kind", ["random", "skewed", "empty"])
def test_sort_by_expert_whole_256_row_tiles(kind):
    """Kernel F's bookkeeping (TM = 256, 600 assignments, so expert counts
    straddle tile boundaries): the JAX package's sort order; each expert's
    rows contiguous from a tile boundary, in expert order, filling
    ceil(count / 256) tiles that tile_expert names; tiles past them dead,
    clamped to the last expert; live_tiles counts the live ones."""
    M = 300
    top_i = _routing(kind, M=M)
    jo, _, _, _ = jsort_by_expert(jnp.asarray(top_i), E, M)
    o, d, t, Mp = sort_by_expert(torch.from_numpy(top_i), E, M)
    assert TM == 256 and Mp == (-(-M * USED // TM) + E) * TM
    assert t.dtype == torch.int32 and t.shape == (Mp // TM,)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    ef = top_i.reshape(-1)[o.numpy()]  # expert of each sorted assignment
    d, t = d.numpy(), t.numpy()
    assert np.all(np.diff(ef) >= 0)
    start = 0
    for e in range(E):
        n = int((ef == e).sum())
        np.testing.assert_array_equal(d[ef == e], start + np.arange(n))
        tiles = -(-n // TM)
        assert (t[start // TM: start // TM + tiles] == e).all()
        start += tiles * TM
    n_live = int(live_tiles(torch.from_numpy(d), torch.from_numpy(t), Mp)[0])
    assert n_live == start // TM and (t[n_live:] == E - 1).all()


# ------------------------------------------------------------ kernel F's plain version

def _expert_weights(qtype, layered, seed=3):
    rng = np.random.default_rng(seed)

    def mk(n, k):
        per = [qtensor_from_float(rng.standard_normal((E, n, k)).astype(np.float32) * 0.05,
                                  qtype, device_put=False) for _ in range(2 if layered else 1)]
        return _stack_qtensors(per, device_put=False) if layered else per[0]

    return mk(NFF, D), mk(NFF, D), mk(D, NFF)


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q8_0])
@pytest.mark.parametrize("layered", [False, True])
def test_grouped_qmm_plain_matches_pallas_interpret(qtype, layered):
    """Both dequantize the expert's weight to bf16 and sum in f32, bf16 out;
    they differ in f32 summation order only (NMSE < 1e-5, the kernels'
    bound). Zero padding rows give 0 in both."""
    gate, _, _ = _expert_weights(qtype, layered)
    assert gate.layout == "kmajor" and gmm_supported(_port(gate), D)
    rng = np.random.default_rng(1)
    M = 48
    top_i = _routing("random", M=M, seed=5)
    x = (rng.standard_normal((M, D)) * 0.3).astype(np.float32)
    o, d, t, Mp = jsort_by_expert(jnp.asarray(top_i), E, M)
    xs_pad = jnp.zeros((Mp, D), jnp.bfloat16).at[d].set(
        jnp.asarray(x, jnp.bfloat16)[np.asarray(o) // USED])
    layer = 1 if layered else None
    want = jgrouped_qmm(xs_pad, t, gate, NFF, layer=None if layer is None else jnp.int32(layer),
                        interpret=True)
    xs_t = torch.from_numpy(np.array(xs_pad.astype(jnp.float32))).to(torch.bfloat16)
    got = grouped_qmm_plain(xs_t, torch.from_numpy(np.array(t)), _port(gate), NFF, layer)
    assert got.shape == tuple(want.shape) and got.dtype == torch.bfloat16
    # the wrapper takes the plain version for CPU tensors
    same = grouped_qmm(xs_t, torch.from_numpy(np.array(t)), _port(gate), NFF, layer)
    assert torch.equal(got, same)
    want = np.asarray(want.astype(jnp.float32))
    assert _nmse(got.float().numpy(), want) < 1e-5
    live = sorted(set((np.asarray(d) // JTM).tolist()))
    dead = [r for r in range(Mp) if r // JTM > live[-1]]
    assert not got.float().numpy()[dead].any() and not want[dead].any()


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q8_0])
@pytest.mark.parametrize("layered", [False, True])
def test_grouped_qmm_plain_tile_256_matches_128(qtype, layered):
    """grouped_qmm_plain on kernel F's 256-row bookkeeping gives every
    assignment, read through dest, the same bits as on the JAX package's
    128-row bookkeeping (a row's product does not depend on the padding
    around it), and so agrees with the Pallas kernel in interpret mode on
    that bookkeeping within the NMSE 1e-5 of the test above. 300 tokens,
    so expert counts straddle both tiles' boundaries."""
    gate, _, _ = _expert_weights(qtype, layered)
    rng = np.random.default_rng(4)
    M = 300
    top_i = _routing("random", M=M, seed=6)
    x = (rng.standard_normal((M, D)) * 0.3).astype(np.float32)
    layer = 1 if layered else None
    got = {}
    for tm in (JTM, TM):
        o, d, t, Mp = sort_by_expert(torch.from_numpy(top_i), E, M, tm=tm)
        xs = torch.zeros((Mp, D), dtype=torch.bfloat16)
        xs[d] = torch.from_numpy(x).to(torch.bfloat16)[o // USED]
        got[tm] = grouped_qmm_plain(xs, t, _port(gate), NFF, layer)[d]
    assert torch.equal(got[TM], got[JTM])
    jo, jd, jt, jMp = jsort_by_expert(jnp.asarray(top_i), E, M)
    xs_pad = jnp.zeros((jMp, D), jnp.bfloat16).at[jd].set(
        jnp.asarray(x, jnp.bfloat16)[np.asarray(jo) // USED])
    want = jgrouped_qmm(xs_pad, jt, gate, NFF, layer=None if layer is None else jnp.int32(layer),
                        interpret=True)
    want = np.asarray(want.astype(jnp.float32))[np.asarray(jd)]
    assert _nmse(got[TM].float().numpy(), want) < 1e-5


# ------------------------------------------------------------ the MoE FFN

def _moe_qw(qtype=GGMLType.Q8_0, router=None, seed=3):
    gate, up, down = _expert_weights(qtype, True, seed)
    rng = np.random.default_rng(seed + 1)
    r = rng.standard_normal((2, E, D)).astype(np.float32) * 0.1 if router is None else router
    jrouter = qtensor_from_float(r, GGMLType.F32, device_put=False)
    jqw = {"moe_gate_inp": jrouter, "moe_gate_exps": gate, "moe_up_exps": up,
           "moe_down_exps": down}
    return jqw, {k: _port(v) for k, v in jqw.items()}


def _cfgs(**kw):
    base = dict(arch="mixtral", n_embd=D, n_ff=NFF, n_expert=E, n_expert_used=USED,
                expert_weights_norm=True)
    base.update(kw)
    return JConfig(**base), ModelConfig(**base)


def test_ragged_prefill_matches_jax_interpret():
    """The port's _moe_prefill_ragged (kernel F's plain version on the CPU)
    against the JAX package's ragged path (Pallas kernel F in interpret
    mode) on the same routing: the same bf16 roundings, f32 sums in another
    order (NMSE < 1e-5)."""
    jqw, qw = _moe_qw()
    jcfg, cfg = _cfgs()
    jcfg._moe_gmm_interpret = True
    x = (np.random.default_rng(2).standard_normal((1, 40, D)) * 0.3).astype(np.float32)
    want = np.asarray(jmoe_ffn(jnp.asarray(x), {}, jqw, jnp.int32(1), jcfg, jnp.float32))
    xt = torch.from_numpy(x)
    probs = torch.softmax(torch.from_numpy(x) @ qw["moe_gate_inp"].data["w"][1].t(), -1)
    top_i = top_k(probs, USED)
    w = torch.gather(probs, -1, top_i)
    w = w / w.sum(-1, keepdim=True)
    got = _moe_prefill_ragged(xt, w, top_i, qw["moe_gate_exps"], qw["moe_up_exps"],
                              qw["moe_down_exps"], 1, cfg, torch.float32)
    assert got.shape == want.shape
    assert _nmse(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [5, 24])
def test_moe_ffn_matches_jax_dense(dtype, T):
    """The port's CPU moe_ffn (every expert, mask-combined) against the JAX
    package's off-TPU path: lax.cond-gated experts at B*T <= 16, the dense
    sum above. f32: summation order only (NMSE < 1e-10). bf16: the same
    roundings at the same places; a matmul summed in another order may
    flip an output's last bit (NMSE < 1e-4)."""
    jqw, qw = _moe_qw(GGMLType.Q4_K)
    jcfg, cfg = _cfgs()
    x = (np.random.default_rng(T).standard_normal((1, T, D)) * 0.5).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jmoe_ffn(jnp.asarray(x, jdt), {}, jqw, jnp.int32(0), jcfg, jdt)
    got = moe_ffn(torch.from_numpy(x).to(tdt), qw, 0, cfg, tdt)
    assert got.dtype == tdt
    err = _nmse(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert err < (1e-10 if dtype == "float32" else 1e-4), err


def test_top_k_ties_match_lax():
    """Exact ties go to the lower index first, as jax.lax.top_k orders them."""
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 4, (256, 8)).astype(np.float32) / 4  # many ties
    for k in (1, 2, 3):
        want = np.asarray(jax.lax.top_k(jnp.asarray(probs), k)[1])
        np.testing.assert_array_equal(top_k(torch.from_numpy(probs), k).numpy(), want)


def test_tied_router_picks_lax_experts():
    """Router rows of experts 1, 2 and 3 identical: the 2nd to 4th logits
    tie exactly, and the port picks the experts lax.top_k picks."""
    rng = np.random.default_rng(7)
    r = rng.standard_normal((2, E, D)).astype(np.float32) * 0.1
    r[:, 2] = r[:, 1]
    r[:, 3] = r[:, 1]
    jqw, qw = _moe_qw(GGMLType.Q8_0, router=r)
    jcfg, cfg = _cfgs()
    x = (rng.standard_normal((1, 12, D)) * 0.5).astype(np.float32)
    logits = torch.from_numpy(x) @ torch.from_numpy(r[0]).t()
    probs = torch.softmax(logits, -1)
    assert (probs[..., 1] == probs[..., 2]).all() and (probs[..., 2] == probs[..., 3]).all()
    jprobs = jax.nn.softmax(jnp.asarray(logits.numpy()), -1)
    np.testing.assert_array_equal(top_k(probs, USED).numpy(),
                                  np.asarray(jax.lax.top_k(jprobs, USED)[1]))
    want = np.asarray(jmoe_ffn(jnp.asarray(x), {}, jqw, jnp.int32(0), jcfg, jnp.float32))
    got = moe_ffn(torch.from_numpy(x), qw, 0, cfg, torch.float32).numpy()
    assert _nmse(got, want) < 1e-10


# ------------------------------------------------------------ loader and end to end

@pytest.fixture(scope="module")
def moe_gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_moe") / "mixtral_q4k.gguf")
    # n_embd 512: the smallest width at which Q4_K takes the K-major layout
    build_llama_gguf(path, arch="mixtral", vocab_size=512, n_embd=512, n_layer=2, n_head=4,
                     n_head_kv=2, n_ff=512, qtype=GGMLType.Q4_K, seed=11, n_expert=4,
                     n_expert_used=2)
    return path


def test_moe_loader_matches_jax(moe_gguf):
    jcfg, jparams, _ = jload(moe_gguf, device_put=False)
    cfg, params, _ = load_model(moe_gguf, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.expert_weights_norm and cfg.n_expert == 4
    lay = params["layers"]
    assert lay["moe_gate_inp"].layout == "dense" and lay["moe_gate_inp"].shape == (2, 4, 512)
    for k in ("moe_gate_exps", "moe_up_exps", "moe_down_exps"):
        assert lay[k].layout == "kmajor" and lay[k].data["q"].dim() == 4
    assert "ffn_gateup" not in lay  # expert gate/up stay unfused
    _same(params, _flatten(jparams))


def _check_generate(cfg, params, jcfg, jparams, prompts=PROMPTS):
    """First-step logits at NMSE < 1e-6 and identical greedy tokens (both
    sides run the plain f32 path)."""
    jr = JEngine(jcfg, jparams, max_seq_len=64, compute_dtype=jnp.float32,
                 decode_chunk=4).generate(prompts, max_new_tokens=8, return_logits=True)
    r = InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                        decode_chunk=4, device="cpu").generate(
        prompts, max_new_tokens=8, return_logits=True)
    nmse = _nmse(r.logits, jr.logits)
    assert nmse < 1e-6, nmse
    assert r.tokens == jr.tokens
    return r


def test_moe_generate_matches_jax(moe_gguf):
    jcfg, jparams, _ = jload(moe_gguf)
    cfg, params, _ = load_model(moe_gguf, device="cpu")
    _check_generate(cfg, params, jcfg, jparams)


def test_moe_params_from_numpy_generate_matches_jax(moe_gguf):
    """from_jax carries the router and the (L, E, ...) experts unchanged."""
    jcfg, jparams, _ = jload(moe_gguf)
    cfg, params = params_from_numpy(dataclasses.asdict(jcfg), _flatten(jparams), device="cpu")
    _same(params, _flatten(jparams))
    _check_generate(cfg, params, jcfg, jparams)


def test_mixtral_arch_snapshot(tmp_path):
    """tests/snapshots/mixtral.npz (the JAX package's golden, from
    build_arch_gguf(seed=11): Q8_0 at n_embd 64, so planar weights) through
    the port's loader and engine on the CPU in f32, with the bar of
    tests/test_arch_snapshots.py:69-73."""
    path = str(tmp_path / "mixtral.gguf")
    build_arch_gguf(path, "mixtral", seed=11)
    cfg, params, _ = load_model(path, device="cpu")
    assert cfg.arch == "mixtral" and cfg.n_expert == 4 and cfg.expert_weights_norm
    assert params["layers"]["moe_gate_exps"].layout == "planar"
    eng = InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                          decode_chunk=4, device="cpu")
    r = eng.generate([[3, 9, 4, 17, 6]], max_new_tokens=8, return_logits=True)
    snap = np.load(os.path.join(SNAP_DIR, "mixtral.npz"))
    logits = np.asarray(r.logits[0], np.float32)
    nmse = _nmse(logits, snap["logits"])
    assert nmse < 1e-6, nmse
    assert (np.asarray(r.tokens[0]) == snap["tokens"]).mean() >= 0.75


def test_llama_arch_experts_not_renormalized(tmp_path):
    """A "llama" GGUF with experts: the JAX registry's llama row has no
    expert_weights_norm, so the top-k weights are not renormalized there,
    and the port follows it (a weak spot of the reference, ROADMAP §3). The
    result differs from the same weights with renormalization."""
    path = str(tmp_path / "llama_moe.gguf")
    build_llama_gguf(path, arch="llama", vocab_size=512, n_embd=512, n_layer=2, n_head=4,
                     n_head_kv=2, n_ff=512, qtype=GGMLType.Q4_K, seed=11, n_expert=4,
                     n_expert_used=2)
    jcfg, jparams, _ = jload(path)
    cfg, params, _ = load_model(path, device="cpu")
    assert not cfg.expert_weights_norm and not jcfg.expert_weights_norm
    r = _check_generate(cfg, params, jcfg, jparams)
    renorm = InferenceEngine(dataclasses.replace(cfg, expert_weights_norm=True), params,
                             max_seq_len=64, compute_dtype=torch.float32, device="cpu")
    assert _nmse(renorm.logits_for(PROMPTS), r.logits) > 1e-4
