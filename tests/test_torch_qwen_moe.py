"""The Qwen MoE archs in the port held against the JAX package on the CPU:
qwen3moe (per-head QK norms, renormalized top-k) and qwen2moe (q/k/v biases,
a shared expert with its per-token sigmoid gate) through their arch
snapshots, at Q4_K K-major widths through the loader and params_from_numpy
against the JAX engine (qwen3moe with Q4_K down experts at K 768, which
load planar), and through a ServerContext against the JAX one; the MoE FFN
with a shared expert against JAX's; planar Q4_K against the JAX dequant;
the expert skip's plain version against the all-expert loop bit for bit,
and its device-side expert list against numpy; the route gate, the config
keys, the loader's and forward's refusals, and the MoE synth. Inputs are
drawn with numpy and handed to both packages.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_qwen_moe.py -q
"""
import dataclasses
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGMLType
from tpullm.gguf.writer import GGUFWriter
from tpullm.models.config import ModelConfig as JConfig
from tpullm.models.llama import moe_ffn as jmoe_ffn
from tpullm.ops.dequant import dequant_jax
from tpullm.ops.qmm import qmm as jqmm
from tpullm.ops.qtensor import QTensor as JQTensor
from tpullm.ops.qtensor import qtensor_from_bytes as jfrom_bytes
from tpullm.ops.qtensor import qtensor_from_float
from tpullm.quant import quantize
from tpullm.runtime.engine import InferenceEngine as JEngine
from tpullm.runtime.loader import _stack_qtensors
from tpullm.runtime.loader import load_model as jload
from tpullm.server.context import GenParams as JGenParams
from tpullm.server.context import ServerContext as JServerContext
from tpullm.server.context import Task as JTask
from tpullm.utils.synth import _add_quant_tensor, build_arch_gguf
from tpullm_torch.models.config import ModelConfig, config_from_gguf
from tpullm_torch.models.llama import KVCache, _moe_loop, forward, moe_ffn, moe_route
from tpullm_torch.ops.dequant import dequant_torch
from tpullm_torch.ops.moe_decode import (MAX_SLOTS, expert_slots, experts_combine,
                                         moe_decode, qmm_experts, skip_supported)
from tpullm_torch.ops.qmm import qmm
from tpullm_torch.ops.qtensor import QTensor, qtensor_from_bytes
from tpullm_torch.runtime.engine import InferenceEngine
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.server.context import GenParams, ServerContext, Task
from tpullm_torch.utils.from_jax import params_from_numpy

torch.set_num_threads(2)

SNAP_DIR = os.path.join(os.path.dirname(__file__), "snapshots")
PROMPTS = [[3, 9, 4, 17, 6], [5, 1, 2], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 2, 3, 4, 5,
                                         6, 7, 8, 9, 30]]
E, USED, D, NFF, NSH = 8, 2, 512, 512, 1024


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


def _port(jq):
    """JAX QTensor -> port QTensor (same arrays)."""
    return QTensor(GGMLType(int(jq.qtype)), tuple(jq.shape),
                   {k: torch.from_numpy(np.array(v)) for k, v in jq.data.items()})


# ----------------------------------------------------------------- snapshots

@pytest.mark.parametrize("arch", ["qwen3moe", "qwen2moe"])
def test_arch_snapshot(arch, tmp_path):
    """tests/snapshots/{arch}.npz (the JAX package's golden, from
    build_arch_gguf(seed=11): Q8_0 at n_embd 64, planar experts) through the
    port's loader and engine on the CPU in f32, with the bar of
    tests/test_arch_snapshots.py:69-73."""
    path = str(tmp_path / f"{arch}.gguf")
    build_arch_gguf(path, arch, seed=11)
    cfg, params, _ = load_model(path, device="cpu")
    assert cfg.arch == arch and cfg.n_expert == 4
    assert cfg.expert_weights_norm == (arch == "qwen3moe")
    eng = InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                          decode_chunk=4, device="cpu")
    r = eng.generate([[3, 9, 4, 17, 6]], max_new_tokens=8, return_logits=True)
    snap = np.load(os.path.join(SNAP_DIR, f"{arch}.npz"))
    nmse = _nmse(np.asarray(r.logits[0], np.float32), snap["logits"])
    assert nmse < 1e-6, (arch, nmse)
    assert (np.asarray(r.tokens[0]) == snap["tokens"]).mean() >= 0.75


# ------------------------------------------------- K-major widths, end to end

def _build(path, arch):
    """qwen3moe: 4 experts of 768 at n_embd 512, Q4_K, so the down experts
    (K 768) are planar; qwen2moe: 4 experts of 512 and a shared expert of
    1024 with its F32 gate vector and the GGUF's
    expert_shared_feed_forward_length key, all Q4_K K-major."""
    write = GGUFWriter.write
    rng = np.random.default_rng(5)

    def write_extra(self):
        if arch == "qwen2moe":
            self.add_uint32("qwen2moe.expert_shared_feed_forward_length", NSH)
            for i in range(2):
                p = f"blk.{i}."
                for name, shape in (("ffn_gate_shexp", (NSH, D)), ("ffn_up_shexp", (NSH, D)),
                                    ("ffn_down_shexp", (D, NSH))):
                    arr = (rng.standard_normal(shape) * 0.05).astype(np.float32)
                    _add_quant_tensor(self, p + name + ".weight", arr, GGMLType.Q4_K)
                self.add_tensor(p + "ffn_gate_inp_shexp.weight",
                                (rng.standard_normal(D) * 0.1).astype(np.float32))
        return write(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(GGUFWriter, "write", write_extra)
        build_arch_gguf(path, arch, n_embd=D, n_head=4, n_head_kv=2,
                        n_ff=768 if arch == "qwen3moe" else NFF, qtype=GGMLType.Q4_K, seed=11)
    return path


@pytest.fixture(scope="module")
def kmajor_models(tmp_path_factory):
    """{arch: (path, JAX config, params, result of PROMPTS)}."""
    out = {}
    d = tmp_path_factory.mktemp("qwen_moe")
    for arch in ("qwen3moe", "qwen2moe"):
        path = _build(str(d / f"{arch}.gguf"), arch)
        jcfg, jparams, _ = jload(path)
        jr = JEngine(jcfg, jparams, max_seq_len=64, compute_dtype=jnp.float32,
                     decode_chunk=4).generate(PROMPTS, max_new_tokens=8, return_logits=True)
        out[arch] = (path, jcfg, jparams, jr)
    return out


@pytest.mark.parametrize("via", ["loader", "params_from_numpy"])
@pytest.mark.parametrize("arch", ["qwen3moe", "qwen2moe"])
def test_kmajor_generate_matches_jax(kmajor_models, arch, via):
    """First-step logits at NMSE < 1e-6 and identical greedy tokens (both
    sides the plain f32 path), the weights laid out as the JAX loader lays
    them: K-major experts, qwen3moe's K-768 Q4_K down experts planar, the
    shared expert unfused and its gate f32."""
    path, jcfg, jparams, jr = kmajor_models[arch]
    if via == "loader":
        cfg, params, _ = load_model(path, device="cpu")
    else:
        cfg, params = params_from_numpy(dataclasses.asdict(jcfg), _flatten(jparams),
                                        device="cpu")
    fields = lambda c: {k: v for k, v in dataclasses.asdict(c).items() if k != "raw_kv"}
    assert fields(cfg) == fields(jcfg)
    lay = params["layers"]
    assert lay["moe_gate_exps"].layout == "kmajor" and lay["moe_gate_exps"].qtype == GGMLType.Q4_K
    if arch == "qwen3moe":
        assert cfg.n_ff_exp == 0 and lay["moe_down_exps"].layout == "planar"
        assert lay["moe_down_exps"].shape == (2, 4, D, 768)
    else:
        assert {k: lay[k].layout for k in ("ffn_gate_shexp", "ffn_up_shexp",
                                           "ffn_down_shexp")} == dict.fromkeys(
            ("ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp"), "kmajor")
        g = lay["moe_gate_inp_shexp"]
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32 and g.shape == (2, D)
    r = InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                        decode_chunk=4, device="cpu").generate(
        PROMPTS, max_new_tokens=8, return_logits=True)
    nmse = _nmse(r.logits, jr.logits)
    assert nmse < 1e-6, nmse
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


@pytest.mark.parametrize("kv", ["f32", "q8"])
@pytest.mark.parametrize("arch", ["qwen3moe", "qwen2moe"])
def test_server_context_matches_jax(kmajor_models, arch, kv):
    """Identical greedy tokens and prefix reuse from the port's and the JAX
    package's ServerContext (token ids, f32 compute, 2 slots, decode chunks
    of 4, prefill chunks of 8)."""
    path, jcfg, jparams, _ = kmajor_models[arch]
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


# ------------------------------------------------------- the MoE FFN and Q4_K

def _stack(rng, n, k, lead=(E,), qtype=GGMLType.Q4_K):
    """A 2-layer stack of (lead..., n, k) weights, as the JAX loader stacks
    them."""
    per = [qtensor_from_float((rng.standard_normal(lead + (n, k)) * 0.05).astype(np.float32),
                              qtype, device_put=False) for _ in range(2)]
    return _stack_qtensors(per, device_put=False)


def _moe_layer(seed, down_qtype=GGMLType.Q4_K, shexp=True):
    """(JAX qw, port qw, the shared expert's gate vectors (2, D)) of a
    2-layer MoE layer stack."""
    rng = np.random.default_rng(seed)
    router = (rng.standard_normal((2, E, D)) * 0.1).astype(np.float32)
    jqw = {"moe_gate_inp": qtensor_from_float(router, GGMLType.F32, device_put=False),
           "moe_gate_exps": _stack(rng, NFF, D), "moe_up_exps": _stack(rng, NFF, D),
           "moe_down_exps": _stack(rng, D, NFF, qtype=down_qtype)}
    if shexp:
        jqw.update(ffn_gate_shexp=_stack(rng, NSH, D, ()), ffn_up_shexp=_stack(rng, NSH, D, ()),
                   ffn_down_shexp=_stack(rng, D, NSH, ()))
    gvec = (rng.standard_normal((2, D)) * 0.1).astype(np.float32)
    return jqw, {k: _port(v) for k, v in jqw.items()}, gvec


@pytest.mark.parametrize("T,dtype", [(5, "float32"), (5, "bfloat16"), (24, "float32")])
def test_moe_ffn_shared_expert_matches_jax(T, dtype):
    """qwen2moe's MoE FFN (routed experts, not renormalized, plus the shared
    expert scaled by its per-token sigmoid gate, added last) against the
    JAX package's on layer 1, at B*T <= 16 (lax.cond-gated experts there)
    and above; the tolerances of tests/test_torch_moe.py's dense test."""
    jqw, qw, gvec = _moe_layer(3)
    base = dict(arch="qwen2moe", n_embd=D, n_ff=NFF, n_expert=E, n_expert_used=USED,
                attn_bias=True, rope_type="neox")
    jcfg, cfg = JConfig(**base), ModelConfig(**base)
    x = (np.random.default_rng(T).standard_normal((1, T, D)) * 0.5).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jmoe_ffn(jnp.asarray(x, jdt), {"moe_gate_inp_shexp": jnp.asarray(gvec[1])}, jqw,
                    jnp.int32(1), jcfg, jdt)
    got = moe_ffn(torch.from_numpy(x).to(tdt), qw, 1, cfg, tdt, torch.from_numpy(gvec[1]))
    assert got.dtype == tdt
    err = _nmse(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert err < (1e-10 if dtype == "float32" else 1e-4), err
    # the gate matters: without it the result moves
    ungated = moe_ffn(torch.from_numpy(x).to(tdt), qw, 1, cfg, tdt)
    assert _nmse(ungated.float().numpy(), got.float().numpy()) > 1e-4


def _q4k_raw(shape, seed):
    rng = np.random.default_rng(seed)
    rows = int(np.prod(shape[:-1]))
    w = (rng.standard_normal((rows, shape[-1])) * 0.02).astype(np.float32)
    return quantize(w, GGMLType.Q4_K).reshape(-1)


@pytest.mark.parametrize("shape", [(3, 5, 256), (40, 768), (4, 64, 768)],
                         ids=lambda s: "x".join(map(str, s)))
def test_planar_q4k_dequant_bit_exact(shape):
    """Planar Q4_K from the JAX package's planar arrays: f32 dequant equal
    bit for bit with tpullm/ops/dequant.py:_dq_q4_K, leading dims kept."""
    jq = jfrom_bytes(_q4k_raw(shape, 1), GGMLType.Q4_K, shape, device_put=False,
                     layout="planar")
    planar = {k: torch.from_numpy(np.array(v)) for k, v in jq.data.items()}
    want = np.asarray(dequant_jax(jq.data, GGMLType.Q4_K, jnp.float32))
    got = dequant_torch(planar, GGMLType.Q4_K, torch.float32)
    assert got.shape == want.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_q4k_stack_at_k768_loads_planar():
    """A Q4_K (E, n, 768) expert stack has no legal K tile (Q4_K's smallest
    is 512), so it loads planar in both packages, with the same arrays; the
    port's qmm on one expert and its row gather give the JAX values."""
    shape = (4, 64, 768)
    raw = _q4k_raw(shape, 2)
    jq = jfrom_bytes(raw, GGMLType.Q4_K, shape, device_put=False)
    q = qtensor_from_bytes(raw, GGMLType.Q4_K, shape)
    assert jq.layout == q.layout == "planar" and q.shape == shape
    for k, v in jq.data.items():
        np.testing.assert_array_equal(q.data[k].numpy(), np.asarray(v))
    np.testing.assert_array_equal(q.dequant(torch.float32).numpy(),
                                  np.asarray(jq.dequant(jnp.float32)))
    x = (np.random.default_rng(3).standard_normal((3, 768))).astype(np.float32)
    one = QTensor(q.qtype, shape[1:], {k: v[2] for k, v in q.data.items()})
    jone = JQTensor(jq.qtype, shape[1:], {k: v[2] for k, v in jq.data.items()})
    np.testing.assert_allclose(qmm(torch.from_numpy(x), one, torch.float32).numpy(),
                               np.asarray(jqmm(jnp.asarray(x), jone, jnp.float32)),
                               rtol=1e-5, atol=1e-6)
    assert not skip_supported(q, 768, 4)


# -------------------------------------------------------------- the expert skip

def _routing(kind, M, seed, n_expert=E, used=USED):
    """(top_i, w) as moe_ffn makes them: random, every row the same
    experts, or one expert in every row."""
    rng = np.random.default_rng(seed)
    if kind == "same":
        top_i = np.tile(np.arange(used) * 3 % n_expert, (M, 1))
    else:
        top_i = np.stack([rng.permutation(n_expert)[:used] for _ in range(M)])
        if kind == "one":
            top_i[:, 0] = n_expert - 1
            top_i[:, 1:] = np.where(top_i[:, 1:] == n_expert - 1, 0, top_i[:, 1:])
    w = rng.random((M, used)).astype(np.float32) + 0.1
    w /= w.sum(-1, keepdims=True)
    return torch.from_numpy(top_i.astype(np.int64)), torch.from_numpy(w)


@pytest.mark.parametrize("kind,M", [("random", 1), ("random", 4), ("random", 16), ("same", 4),
                                    ("one", 7)])
def test_expert_slots_match_numpy(kind, M):
    """The device-side expert list: the experts any row selected, ascending,
    padded with -1 to min(E, rows * used), int32."""
    top_i, _ = _routing(kind, M, seed=M)
    ids = expert_slots(top_i.reshape(1, M, USED), E)
    want = sorted(set(top_i.reshape(-1).tolist()))
    cap = min(E, M * USED)
    assert ids.dtype == torch.int32 and ids.shape == (cap,)
    assert ids.tolist() == want + [-1] * (cap - len(want))


@pytest.mark.parametrize("down_qtype,layer,kind,M,dtype", [
    (GGMLType.Q4_K, 1, "random", 1, "float32"), (GGMLType.Q4_K, 1, "random", 4, "bfloat16"),
    (GGMLType.Q4_K, 1, "random", 16, "float32"), (GGMLType.Q4_K, 1, "same", 4, "bfloat16"),
    (GGMLType.Q4_K, 1, "one", 7, "float32"), (GGMLType.Q6_K, None, "random", 4, "bfloat16"),
    (GGMLType.Q6_K, 1, "one", 7, "bfloat16"), (GGMLType.Q6_K, None, "random", 16, "float32")],
    ids=lambda v: getattr(v, "name", str(v)))
def test_skip_plain_equals_expert_loop(down_qtype, layer, kind, M, dtype):
    """The expert skip's plain version (the listed experts only: gate and up
    on the shared rows, down on each slot's rows and the combine in expert
    order) equals the all-expert loop of moe_ffn bit for bit on the CPU, on
    layer 1 of (L, E) stacks and on (E,) stacks, with the list below and at
    capacity E, rows that select the same experts, one expert in every row."""
    _, qw, _ = _moe_layer(7, down_qtype, shexp=False)
    if layer is None:
        qw = {k: QTensor(v.qtype, v.shape[1:], {n: a[1] for n, a in v.data.items()})
              for k, v in qw.items()}
    tdt = getattr(torch, dtype)
    top_i, w = _routing(kind, M, seed=M + 1)
    x = (torch.from_numpy(np.random.default_rng(M).standard_normal((1, M, D)).astype(
        np.float32)) * 0.5).to(tdt)
    args = (x, w[None], top_i[None], qw["moe_gate_exps"], qw["moe_up_exps"],
            qw["moe_down_exps"], layer)
    want = _moe_loop(*args, E, tdt)
    got = moe_decode(*args, E, tdt)
    assert got.dtype == tdt and got.shape == want.shape
    assert torch.equal(got, want)


def test_skip_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors qmm_experts and experts_combine run their plain
    versions: each slot the listed expert's product, a padded slot 0."""
    _, qw, _ = _moe_layer(9, shexp=False)
    top_i, w = _routing("random", 2, seed=3)
    ids = expert_slots(top_i, E)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, D)).astype(np.float32))
    g = qmm_experts(x, qw["moe_gate_exps"], 1, ids, torch.float32)
    assert g.shape == (4, 2, NFF)
    for slot, e in enumerate(ids.tolist()):
        if e < 0:
            assert not g[slot].any()
            continue
        one = QTensor(GGMLType.Q4_K, (NFF, D), {k: v[1, e] for k, v in
                                                qw["moe_gate_exps"].data.items()})
        assert torch.equal(g[slot], qmm(x, one, torch.float32))
    out = experts_combine(g, qw["moe_down_exps"], 1, ids, top_i, w, torch.float32)
    assert out.shape == (2, D) and torch.isfinite(out).all()


def test_moe_route_gate():
    """The route of the routed experts: the CPU always loops; on the card
    B*T <= 16 takes the skip over K-major stacks and the loop over a planar
    one (qwen3moe's Q4_K down experts at K 768) or over more slots,
    min(E, B*T * used), than the combine holds (MAX_SLOTS), B*T > 16 kernel
    F where it takes every stack, else the loop."""
    _, qw, _ = _moe_layer(4, shexp=False)
    gate, up, down = qw["moe_gate_exps"], qw["moe_up_exps"], qw["moe_down_exps"]
    planar = qtensor_from_bytes(_q4k_raw((1, 2, 256, 768), 6), GGMLType.Q4_K, (1, 2, 256, 768))
    assert moe_route(False, 4, gate, up, down, D, USED) == "loop"
    assert moe_route(False, 64, gate, up, down, D, USED) == "loop"
    assert moe_route(True, 1, gate, up, down, D, USED) == "skip"
    assert moe_route(True, 16, gate, up, down, D, USED) == "skip"
    assert moe_route(True, 17, gate, up, down, D, USED) == "ragged"
    assert moe_route(True, 4, gate, up, planar, D, USED) == "loop"
    assert moe_route(True, 2048, gate, up, planar, D, USED) == "loop"
    assert skip_supported(gate, D, E) and not skip_supported(
        QTensor(GGMLType.Q4_K, (NFF, D), {k: v[1, 0] for k, v in gate.data.items()}), D, E)
    assert skip_supported(gate, D, MAX_SLOTS) and not skip_supported(gate, D, MAX_SLOTS + 1)


# ------------------------------------------------------ config, loader, synth

class _Meta:
    """The metadata face of a GGUFFile: all config_from_gguf reads."""

    def __init__(self, arch, metadata):
        self.metadata = {"general.architecture": arch, **metadata}
        self.architecture = arch

    def get(self, key, default=None):
        return self.metadata.get(key, default)


def test_qwen_moe_keys_parse():
    """The keys a qwen2moe / qwen3moe GGUF carries parse as the JAX parser
    parses them; expert_shared_feed_forward_length is read by neither."""
    keys = {"embedding_length": 2048, "attention.head_count": 32, "attention.key_length": 128,
            "expert_count": 128, "expert_used_count": 8, "expert_feed_forward_length": 768}
    cfg = config_from_gguf(_Meta("qwen3moe", {f"qwen3moe.{k}": v for k, v in keys.items()}))
    assert (cfg.head_dim, cfg.n_expert, cfg.n_expert_used, cfg.n_ff_exp) == (128, 128, 8, 768)
    assert cfg.attn_qk_norm and cfg.expert_weights_norm and cfg.rope_type == "neox"
    cfg = config_from_gguf(_Meta("qwen2moe", {
        "qwen2moe.expert_count": 64, "qwen2moe.expert_used_count": 8,
        "qwen2moe.expert_shared_feed_forward_length": 20480}))
    assert cfg.attn_bias and not cfg.expert_weights_norm and cfg.n_expert_shared == 0


@pytest.mark.parametrize("key,value", [
    ("qwen3moe.interleave_moe_layer_step", 2), ("qwen2moe.experts_per_group", 2),
    ("qwen3moe.expert_group_count", 4), ("qwen3moe.expert_chunk_feed_forward_length", 64)])
def test_graph_changing_key_raises(key, value):
    arch = key.split(".")[0]
    with pytest.raises(NotImplementedError, match=key):
        config_from_gguf(_Meta(arch, {key: value}))


def test_shared_expert_refusals(tmp_path, kmajor_models):
    """A shared expert without all of gate, up and down raises at load; on
    a layer without routed experts, or its gate without it, it raises in
    forward (the graph would not read it)."""
    path, _, _, _ = kmajor_models["qwen2moe"]
    cfg, params, _ = load_model(path, device="cpu")
    cache = KVCache.create(cfg, 1, 16, torch.float32, "cpu")
    tok = torch.zeros((1, 4), dtype=torch.int64)
    vf = torch.zeros(1, dtype=torch.int64)
    lay = params["layers"]
    no_gate = dict(params, layers={k: v for k, v in lay.items() if k != "ffn_gate_shexp"})
    with pytest.raises(NotImplementedError, match="shared expert"):
        forward(no_gate, cfg, tok, tok, cache, 0, vf, torch.float32)
    gate_only = dict(params, layers={k: v for k, v in lay.items() if "shexp" not in k
                                     or k == "moe_gate_inp_shexp"})
    with pytest.raises(NotImplementedError, match="moe_gate_inp_shexp"):
        forward(gate_only, cfg, tok, tok, cache, 0, vf, torch.float32)
    dense = dict(params, layers={k: v for k, v in lay.items() if not k.startswith("moe_")})
    with pytest.raises(NotImplementedError, match="reads none of them"):
        forward(dense, dataclasses.replace(cfg, n_expert=0, n_expert_used=0), tok, tok,
                cache, 0, vf, torch.float32)

    write = GGUFWriter.write

    def write_partial(self):
        self.add_tensor("blk.0.ffn_up_shexp.weight", np.zeros((NSH, D), np.float32))
        return write(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(GGUFWriter, "write", write_partial)
        part = build_arch_gguf(str(tmp_path / "p.gguf"), "qwen2moe", n_embd=D, n_head=4,
                               n_head_kv=2, n_ff=NFF, qtype=GGMLType.Q4_K, seed=1)
    with pytest.raises(NotImplementedError, match="ffn_up_shexp"):
        load_model(part, device="cpu")


def _digest(cfg, params):
    h = hashlib.sha256()

    def walk(k, v):
        if isinstance(v, dict):
            for n in sorted(v):
                walk(k + "." + n, v[n])
        elif isinstance(v, QTensor):
            h.update(f"{k}:{int(v.qtype)}:{v.shape}".encode())
            walk(k, v.data)
        else:
            h.update(k.encode())
            h.update(v.contiguous().cpu().numpy().tobytes())

    walk("", params)
    h.update(repr(dataclasses.asdict(cfg)).encode())
    return h.hexdigest()[:16]


def test_synth_draws_unchanged():
    """synth_mixtral_q4k (now synth_moe_q4k's Mixtral form) and
    synth_kmajor_q4k_fast at its default head_dim draw what they drew
    before: digests of every array and the config, taken on the CPU before
    the generalisation."""
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast, synth_mixtral_q4k

    kw = dict(vocab_size=256, n_embd=256, n_layer=2, n_head=2, n_head_kv=1, n_ff=256)
    assert _digest(*synth_mixtral_q4k(**kw, n_expert=4, n_expert_used=2, seed=3,
                                      device="cpu")) == "3f263c2d1844db02"
    for arch, want in (("llama", "0cf8f0e4e4956b51"), ("qwen3", "016d94bdfe04a9d0"),
                       ("qwen2", "3f2b5a3085c6f8f9")):
        got = _digest(*synth_kmajor_q4k_fast(**kw, seed=5, centred=True, device="cpu",
                                             arch=arch))
        assert got == want, arch


@pytest.mark.parametrize("arch", ["qwen3moe", "qwen2moe"])
def test_synth_moe(arch):
    """synth_moe_q4k: head_dim over a narrower or wider stream, the expert
    width, the down experts' type, the shared expert and its f32 gate, the
    arch row's flags; a forward on the CPU runs through them."""
    from tpullm_torch.utils.synth import synth_moe_q4k

    kw = dict(head_dim=64, down_qtype=GGMLType.Q6_K) if arch == "qwen3moe" else dict(
        n_ff_shexp=512)
    cfg, params = synth_moe_q4k(arch=arch, vocab_size=300, n_embd=256, n_layer=2, n_head=4,
                                n_head_kv=2, n_ff=1024, n_expert=8, n_expert_used=2,
                                n_ff_exp=256, rms_eps=1e-6, exact_vocab=True, seed=2,
                                device="cpu", **kw)
    lay = params["layers"]
    assert (cfg.arch, cfg.n_expert, cfg.n_ff_exp, cfg.rope_base, cfg.rms_eps) == (
        arch, 8, 256, 1e6, 1e-6)
    assert lay["moe_gate_exps"].shape == (2, 8, 256, 256)
    assert lay["moe_down_exps"].shape == (2, 8, 256, 256)
    if arch == "qwen3moe":
        assert cfg.head_dim == 64 and cfg.attn_qk_norm and cfg.expert_weights_norm
        assert lay["moe_down_exps"].qtype == GGMLType.Q6_K and lay["q_norm"].shape == (2, 64)
        assert lay["wqkv"].shape == (2, 256 + 256 + 256, 256) and lay["wo"].shape == (2, 256, 256)
    else:
        assert cfg.head_dim == 64 and cfg.attn_bias and not cfg.expert_weights_norm
        assert lay["ffn_gate_shexp"].shape == (2, 512, 256)
        assert lay["ffn_down_shexp"].shape == (2, 256, 512)
        assert lay["moe_gate_inp_shexp"].shape == (2, 256)
    cache = KVCache.create(cfg, 1, 16, torch.float32, "cpu")
    tok = torch.tensor([[3, 9, 4, 17]])
    lg = forward(params, cfg, tok, torch.arange(4)[None], cache, 0,
                 torch.zeros(1, dtype=torch.int64), torch.float32)[0]
    assert lg.shape == (1, 4, 300) and torch.isfinite(lg).all()
