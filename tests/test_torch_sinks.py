"""Attention sinks, the clamped SwiGLU with the router's and the experts'
biases, planar MXFP4 and the attention value scale in the port (gpt-oss,
mimo2), held against the JAX package on the CPU: planar MXFP4 bit for bit
against dequant_jax; the einsum attention with sinks (plain, windowed, on
the iSWA ring, on int8 views) and kernel E's plain version at head dim 64
against the JAX attention; ffn and moe_ffn with swiglu_oai, the router bias
and the expert biases (the loop, K-major and planar MXFP4, and the skip's
plain version) against the JAX functions; YaRN at gpt-oss's values against
the JAX rope; small gpt-oss MoE files (MXFP4 experts at K 160, which no
K-major tile takes, biases, sinks, a per-layer SWA array or none) and a
mimo2 file with sinks on some layers only, through both engines. Inputs are
drawn with numpy and handed to both packages.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_sinks.py -q
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpullm_torch.models.llama as llama
from tpullm.gguf.constants import GGML_QUANT_SIZES, GGMLType
from tpullm.gguf.writer import GGUFWriter
from tpullm.models.config import ModelConfig as JConfig
from tpullm.models.llama import _kv_quant as j_kv_quant
from tpullm.models.llama import attention as jattention
from tpullm.models.llama import ffn as jffn
from tpullm.models.llama import moe_ffn as jmoe_ffn
from tpullm.models.llama import rope_cache as jrope_cache
from tpullm.ops.dequant import dequant_jax
from tpullm.ops.layer_kernel import supported as jblock_supported
from tpullm.ops.qtensor import qtensor_from_bytes as jfrom_bytes
from tpullm.ops.qtensor import qtensor_from_float
from tpullm.runtime.engine import InferenceEngine as JEngine
from tpullm.runtime.loader import _stack_qtensors
from tpullm.runtime.loader import load_model as jload
from tpullm.server.context import GenParams as JGenParams
from tpullm.server.context import ServerContext as JServerContext
from tpullm.server.context import Task as JTask
from tpullm.utils.synth import _add_quant_tensor, add_spm_toy_vocab, build_arch_gguf
from tpullm_torch.models.config import ModelConfig
from tpullm_torch.models.llama import (attention, attention_route, decode_route, ffn,
                                       layer_routes, layer_windows, moe_ffn, moe_route,
                                       rope_cache)
from tpullm_torch.ops.flash_decode import flash_decode
from tpullm_torch.ops.layer_kernel import supported as block_supported
from tpullm_torch.ops.moe_decode import moe_decode
from tpullm_torch.ops.qtensor import QTensor, qtensor_from_bytes
from tpullm_torch.runtime.engine import InferenceEngine
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.server.context import GenParams, ServerContext, Task

torch.set_num_threads(2)

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


# ---------------------------------------------------------------- planar MXFP4

@pytest.mark.parametrize("shape", [(4, 64), (3, 8, 160), (5, 2880)],
                         ids=["K64", "experts_K160", "K2880"])
def test_planar_mxfp4_bit_exact(shape):
    """MXFP4 rows the K-major kernels do not take load planar and
    dequantize bit for bit as dequant_jax (f32): random codes and e8m0
    bytes over the whole range, the subnormal scales e = 0 and 1 among
    them (XLA reads those as zero, so their blocks are +-0)."""
    blk, bs = GGML_QUANT_SIZES[GGMLType.MXFP4]
    rows = int(np.prod(shape[:-1]))
    nb = shape[-1] // blk
    rng = np.random.default_rng(shape[-1])
    raw = rng.integers(0, 256, (rows, nb, bs), dtype=np.uint8)
    raw[..., 0] = rng.integers(0, 255, (rows, nb))  # e8m0, 255 (NaN) left out
    raw[0, :2, 0] = (0, 1)
    raw = raw.reshape(rows, nb * bs)
    jq = jfrom_bytes(raw, GGMLType.MXFP4, shape, device_put=False)
    q = qtensor_from_bytes(raw, GGMLType.MXFP4, shape)
    assert q.layout == jq.layout == "planar"
    want = np.asarray(dequant_jax({k: jnp.asarray(v) for k, v in jq.data.items()},
                                  GGMLType.MXFP4, jnp.float32))
    got = q.dequant(torch.float32).numpy()
    assert got.shape == shape
    assert np.array_equal(got.view(np.uint32), want.reshape(shape).view(np.uint32))
    assert not got.reshape(-1, shape[-1])[0, :64].any()


# ------------------------------------------------------- attention with sinks

def _attn_case(case, D=64, seed=0):
    """(q, k, v, q_slots, kv_positions, positions, valid_from) in numpy, f32
    head-major K/V, and the call's (window, ring, T): ``plain`` a 6-token
    chunk over 32 slots, ``window`` the same with a window of 8,
    ``ring`` a 5-token chunk over a 24-slot ring at positions 40-44 (slots
    wrapped), ``decode`` one token; rows with their own valid_from."""
    rng = np.random.default_rng(seed)
    B, H, Hkv = 2, 8, 2
    T, S, first, ring, window = {"plain": (6, 32, 20, 0, 0), "window": (6, 32, 20, 0, 8),
                                 "ring": (5, 24, 40, 24, 16), "decode": (1, 32, 25, 0, 0)}[case]
    q = (rng.standard_normal((B, T, H, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, Hkv, S, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, Hkv, S, D)) * 0.5).astype(np.float32)
    vf = np.asarray([0, 3], np.int64)
    qs = (first + np.arange(T))[None, :].repeat(B, 0).astype(np.int64)
    kvp = np.arange(S)[None, :] - vf[:, None]
    return (q, k, v, qs, kvp, qs - vf[:, None], vf), window, ring


@pytest.mark.parametrize("case,q8", [("plain", False), ("plain", True), ("window", False),
                                     ("window", True), ("ring", False), ("decode", False),
                                     ("decode", True)])
def test_einsum_attention_with_sinks_matches_jax(case, q8):
    """The port's attention with sinks (the einsum path on the CPU) against
    the JAX attention(..., sinks=) in f32: NMSE < 1e-10. On int8 views the
    port dequantizes inside attention, the JAX side gets the same
    dequantized rows (its einsum path off the TPU). The sinks are live:
    without them the output moves. (The int8 cache has no ring: KVCache.create,
    llama.py:80-117.)"""
    (q, k, v, qs, kvp, pos, vf), window, ring = _attn_case(case)
    fields = dict(n_head=8, n_head_kv=2, head_dim=64, head_dim_v=64, sliding_window=window)
    jcfg, cfg = JConfig(**fields), ModelConfig(**fields)
    sinks = (np.random.default_rng(9).standard_normal(8) * 2).astype(np.float32)
    T = torch.from_numpy
    args = (T(qs), T(kvp), T(pos), T(vf))
    kv_q8 = None
    if q8:
        (kq, ks), (vq, vs) = llama._kv_quant(T(k)), llama._kv_quant(T(v))
        kv_q8 = (kq, vq, ks, vs)
        k = (kq.float() * ks[..., None]).numpy()
        v = (vq.float() * vs[..., None]).numpy()
    swa = bool(window)
    want = np.asarray(jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qs),
                                 jnp.asarray(kvp), jnp.asarray(pos), jnp.asarray(vf), jcfg, swa,
                                 sinks=jnp.asarray(sinks), ring=ring))
    kt, vt = (None, None) if q8 else (T(k), T(v))
    got = attention(T(q), kt, vt, *args, cfg, swa, kv_q8=kv_q8, ring=ring, sinks=T(sinks))
    free = attention(T(q), kt, vt, *args, cfg, swa, kv_q8=kv_q8, ring=ring)
    assert _nmse(got.numpy(), want) < 1e-10, _nmse(got.numpy(), want)
    assert _nmse(free.numpy(), want) > 1e-4


def test_sinks_on_a_row_with_no_visible_key_give_zero():
    """A row whose valid_from is past its query slot attends to nothing:
    the sink has no value row, so it outputs 0, as the JAX attention."""
    (q, k, v, qs, kvp, pos, vf), _, _ = _attn_case("decode")
    vf = np.asarray([qs[0, 0] + 1, 0], np.int64)
    cfg = ModelConfig(n_head=8, n_head_kv=2, head_dim=64, head_dim_v=64)
    T = torch.from_numpy
    got = attention(T(q), T(k), T(v), T(qs), T(kvp), T(qs - vf[:, None]), T(vf), cfg,
                    sinks=torch.ones(8))
    assert not got[0].any() and got[1].abs().sum() > 0


def _decode_case(T, q8, ring, seed):
    """Kernel E's shapes at gpt-oss's heads (G = 8, head dim 64): 2 rows of
    T tokens over 512 slots (a 200-slot ring at positions 700+), bf16."""
    rng = np.random.default_rng(seed)
    B, H, Hkv, D = 2, 16, 2, 64
    S = 200 if ring else 512
    q = (rng.standard_normal((B, T, H, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, Hkv, S, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, Hkv, S, D)) * 0.5).astype(np.float32)
    first = np.asarray([700, 703] if ring else [400, 130])
    qs = (first[:, None] + np.arange(T)[None]).astype(np.int64)
    vf = np.asarray([0, 2], np.int64)
    return q, k, v, qs, vf


@pytest.mark.parametrize("kind", ["bf16", "int8", "ring"])
@pytest.mark.parametrize("T", [1, 8])
def test_flash_decode_head_dim_64_with_sinks_matches_jax(kind, T):
    """Kernel E's plain version (flash_decode on CPU tensors) at head dim 64
    with sinks and a window of 128, G * T up to 64 rows a kv head, against
    the JAX einsum attention(..., sinks=) on the same bf16 rows (the oracle:
    the JAX gate sends head dim 64 to its einsum path): NMSE < 1e-4, < 1e-3
    for multi-token int8 (the plain version folds the scales into scores
    and probabilities, the einsum path reads the dequantized rows), the
    bounds of tests/test_torch_flash_decode.py."""
    ring = 200 if kind == "ring" else 0
    q8 = kind == "int8"
    q, k, v, qs, vf = _decode_case(T, q8, ring, seed=T)
    fields = dict(n_head=16, n_head_kv=2, head_dim=64, head_dim_v=64, sliding_window=128)
    jcfg, cfg = JConfig(**fields), ModelConfig(**fields)
    sinks = (np.random.default_rng(3).standard_normal(16) * 2).astype(np.float32)
    S = k.shape[2]
    kvp = np.arange(S)[None, :] - vf[:, None]
    pos = qs - vf[:, None]
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
    ti = [torch.from_numpy(a) for a in (qs, pos, vf)]
    if q8:
        (kq, ks), (vq, vs) = llama._kv_quant(tk), llama._kv_quant(tv)
        jkq, jks = j_kv_quant(jnp.asarray(k, jnp.bfloat16))
        assert np.array_equal(kq.numpy(), np.asarray(jkq)) and np.array_equal(
            ks.numpy(), np.asarray(jks))
        out = flash_decode(tq, kq, vq, *ti, cfg, 128, torch.from_numpy(sinks), k_scales=ks,
                           v_scales=vs)
        tk = (kq.float() * ks[..., None]).to(torch.bfloat16)
        tv = (vq.float() * vs[..., None]).to(torch.bfloat16)
    else:
        out = flash_decode(tq, tk, tv, *ti, cfg, 128, torch.from_numpy(sinks), ring=ring)
    jb = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    want = jattention(jb(tq), jb(tk), jb(tv), jnp.asarray(qs), jnp.asarray(kvp),
                      jnp.asarray(pos), jnp.asarray(vf), jcfg, True,
                      sinks=jnp.asarray(sinks), ring=ring)
    tol = 1e-3 if q8 and T > 1 else 1e-4
    err = _nmse(out.float().numpy(), np.asarray(want, np.float32))
    assert err < tol, err


# ------------------------------------------------------------------- routes

def test_sinks_keep_calls_off_kernel_c(monkeypatch):
    """A call with sinks never takes kernel C, plain or ring, by the JAX
    prefill gate (``sinks is None``, llama.py:268); kernel E takes it where
    it would without sinks. decode_route and so each captured step's key
    tell a model with sinks apart: with E off, a ring step is C without
    sinks and the einsum path with them."""
    for flag in (None, "1"):
        if flag:
            monkeypatch.setenv("TPULLM_FLASH_DECODE", flag)
        else:
            monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
        for T, S, ring in ((512, 1024, 0), (128, 256, 0), (1, 1024, 0), (64, 384, 384),
                           (1, 384, 384)):
            for D in (64, 128, 256):
                plain = attention_route(True, 2, T, S, D, D, 16, 8, torch.bfloat16, ring)
                sunk = attention_route(True, 2, T, S, D, D, 16, 8, torch.bfloat16, ring,
                                       sinks=True)
                assert sunk != "flash_attention"
                assert sunk == ("einsum" if plain == "flash_attention" else plain)
    monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
    cfg = ModelConfig(n_head=16, n_head_kv=8, head_dim=128, head_dim_v=128)
    assert decode_route(cfg, 4, 1024, torch.bfloat16, True, 384) == ("einsum", "flash_attention")
    assert decode_route(cfg, 4, 1024, torch.bfloat16, True, 384, sinks=True) == ("einsum",
                                                                                "einsum")


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8])
def test_head_dim_64_takes_e_on_the_ports_own_route(monkeypatch, kv_dtype):
    """gpt-oss's decode (64 heads of 64 over 8 kv heads, G = 8) takes kernel
    E on the card under TPULLM_FLASH_DECODE, plain banks and the bf16 ring:
    the port's own route, as the JAX gate asks Dk % 128 == 0
    (tpullm/ops/flash_decode.py:254). Without the flag, or on the CPU, the
    einsum path; prefill at head dim 64 has no kernel C and stays on it."""
    from tpullm.ops.flash_decode import flash_decode_supported as jsupported

    monkeypatch.setenv("TPULLM_FLASH_DECODE", "1")
    assert not jsupported(4, 1, 8192, 64, 64, 8)
    for T in (1, 8):
        assert attention_route(True, 4, T, 8192, 64, 64, 64, 8, kv_dtype) == "flash_decode"
        assert attention_route(False, 4, T, 8192, 64, 64, 64, 8, kv_dtype) == "einsum"
        if kv_dtype == torch.bfloat16:
            assert attention_route(True, 4, T, 640, 64, 64, 64, 8, kv_dtype, 640) == (
                "flash_decode")
    assert attention_route(True, 4, 9, 8192, 64, 64, 64, 8, kv_dtype) == "einsum"
    assert attention_route(True, 1, 512, 1024, 64, 64, 64, 8, torch.bfloat16) == "einsum"
    assert attention_route(True, 4, 8, 8192, 64, 64, 128, 8, kv_dtype) == "einsum"  # G*T > 64
    monkeypatch.delenv("TPULLM_FLASH_DECODE")
    assert attention_route(True, 4, 1, 8192, 64, 64, 64, 8, kv_dtype) == "einsum"


# ------------------------------------------------------ the FFN and the MoE

E, USED, D, NFF = 4, 2, 512, 512


def _stack(rng, n, k, lead=(E,), qtype=GGMLType.Q4_K):
    """A 2-layer stack of (lead..., n, k) weights, as the JAX loader stacks
    them (K-major where the kernels take K, else planar)."""
    per = [qtensor_from_float((rng.standard_normal(lead + (n, k)) * 0.05).astype(np.float32),
                              qtype, device_put=False) for _ in range(2)]
    return _stack_qtensors(per, device_put=False)


@functools.lru_cache(maxsize=2)
def _moe_layer(qtype):
    """(JAX qw, port qw, the layer-1 biases by key) of a 2-layer MoE stack of
    4 experts: Q4_K at K 512 (K-major) or MXFP4 at K 160 (planar, as
    gpt-oss's K 2880), with the router's bias and the expert biases."""
    d = D if qtype == GGMLType.Q4_K else 160
    rng = np.random.default_rng(5)
    router = (rng.standard_normal((2, E, d)) * 0.1).astype(np.float32)
    jqw = {"moe_gate_inp": qtensor_from_float(router, GGMLType.F32, device_put=False),
           "moe_gate_exps": _stack(rng, d, d, qtype=qtype),
           "moe_up_exps": _stack(rng, d, d, qtype=qtype),
           "moe_down_exps": _stack(rng, d, d, qtype=qtype)}
    bias = {"moe_gate_inp_b": rng.standard_normal(E) * 0.5,
            "moe_gate_exps_b": rng.standard_normal((E, d)) * 0.5,
            "moe_up_exps_b": rng.standard_normal((E, d)) * 0.5,
            "moe_down_exps_b": rng.standard_normal((E, d)) * 0.1}
    bias = {k: v.astype(np.float32) for k, v in bias.items()}
    return jqw, {k: _port(v) for k, v in jqw.items()}, bias


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.MXFP4], ids=["Q4_K", "MXFP4_planar"])
@pytest.mark.parametrize("T", [5, 24])
@pytest.mark.parametrize("biases", ["all", "router", "none"])
def test_moe_ffn_swiglu_oai_and_biases_match_jax(monkeypatch, qtype, T, biases):
    """moe_ffn with swiglu_oai, the router's bias on the logits and each
    expert's gate, up and down biases against the JAX moe_ffn on layer 1,
    at B*T <= 16 (the JAX lax.cond-gated experts) and above (its dense
    loop), in f32: the same top-k picks, NMSE < 1e-10. Each bias is live."""
    jqw, qw, bias = _moe_layer(qtype)
    keep = {"all": bias, "router": {"moe_gate_inp_b": bias["moe_gate_inp_b"]},
            "none": {}}[biases]
    d = qw["moe_gate_exps"].shape[-1]
    base = dict(arch="gpt-oss", n_embd=d, n_ff=d, n_expert=E, n_expert_used=USED,
                act_fn="swiglu_oai")
    jcfg, cfg = JConfig(**base), ModelConfig(**base)
    x = (np.random.default_rng(T).standard_normal((1, T, d)) * 0.5).astype(np.float32)
    want = jmoe_ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in keep.items()}, jqw,
                    jnp.int32(1), jcfg, jnp.float32)
    xt = torch.from_numpy(x)
    got = moe_ffn(xt, qw, 1, cfg, torch.float32, bias={k: torch.from_numpy(v)
                                                        for k, v in keep.items()})
    err = _nmse(got.numpy(), np.asarray(want))
    assert err < 1e-10, err
    if keep:
        free = moe_ffn(xt, qw, 1, cfg, torch.float32)
        assert _nmse(free.numpy(), got.numpy()) > 1e-6


def test_dense_ffn_swiglu_oai_matches_jax():
    """The dense gated FFN with swiglu_oai (gpt-oss's snapshot file) against
    the JAX ffn on layer 1, separate and fused gate/up, in f32: NMSE <
    1e-10; the clamps bite (gate values above 7, up values outside +-7)."""
    rng = np.random.default_rng(2)
    jqw = {"ffn_gate": _stack(rng, NFF, D, ()), "ffn_up": _stack(rng, NFF, D, ()),
           "ffn_down": _stack(rng, D, NFF, ())}
    qw = {k: _port(v) for k, v in jqw.items()}
    base = dict(arch="gpt-oss", n_embd=D, n_ff=NFF, act_fn="swiglu_oai")
    jcfg, cfg = JConfig(**base), ModelConfig(**base)
    x = (rng.standard_normal((2, 3, D)) * 8).astype(np.float32)
    want = np.asarray(jffn(jnp.asarray(x), jqw, jnp.int32(1), jcfg, jnp.float32))
    got = ffn(torch.from_numpy(x), qw, 1, cfg, torch.float32)
    assert _nmse(got.numpy(), want) < 1e-10
    g = llama.qmm(torch.from_numpy(x), qw["ffn_gate"], torch.float32, 1)
    u = llama.qmm(torch.from_numpy(x), qw["ffn_up"], torch.float32, 1)
    assert (g > 7).any() and (u.abs() > 7).any()


def test_skip_with_swiglu_oai_equals_the_loop():
    """Kernel A's expert skip (its plain version on the CPU) with swiglu_oai
    equals the all-expert loop bit for bit on an unbiased K-major stack; a
    biased stack takes the loop on the card at decode and prefill (the JAX
    gate keeps it off F, _ragged_moe_ok, llama.py:524; the skip's kernels
    add no bias), where an unbiased one takes the skip and F."""
    _, qw, _ = _moe_layer(GGMLType.Q4_K)
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.standard_normal((2, 2, D)) * 0.5).astype(np.float32))
    top_i = torch.from_numpy(rng.permuted(np.tile(np.arange(E), (4, 1)), axis=1)[:, :USED]
                             .reshape(2, 2, USED).astype(np.int64))
    w = torch.from_numpy(rng.random((2, 2, USED)).astype(np.float32))
    act = lambda g, u: llama.gated_act(g, u, "swiglu_oai", torch.float32)
    gw, uw, dw = qw["moe_gate_exps"], qw["moe_up_exps"], qw["moe_down_exps"]
    skip = moe_decode(x, w, top_i, gw, uw, dw, 1, E, torch.float32, act)
    loop = llama._moe_loop(x, w, top_i, gw, uw, dw, 1, E, torch.float32, act)
    assert torch.equal(skip, loop)
    assert moe_route(True, 4, gw, uw, dw, D, USED) == "skip"
    assert moe_route(True, 2048, gw, uw, dw, D, USED) == "ragged"
    for rows in (1, 4, 16, 2048):
        assert moe_route(True, rows, gw, uw, dw, D, USED, biased=True) == "loop"


def test_layer_kernel_gate_on_swiglu_oai():
    """D takes a dense swiglu_oai layer where the JAX gate does (its gate
    asks no act_fn but xielu), and gpt-oss's layers, with their q/k/v
    biases, stay off it as in the JAX gate; mimo2's value scale keeps a
    layer off it (the port's own condition: D adds wo's product
    unscaled)."""
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    cfg, params = synth_kmajor_q4k_fast(vocab_size=256, n_embd=512, n_layer=1, n_head=4,
                                        n_head_kv=2, n_ff=512, device="cpu")
    cfg = dataclasses.replace(cfg, act_fn="swiglu_oai")
    gl = params["layers"]
    qw = {k: v for k, v in gl.items() if isinstance(v, QTensor)}
    jcfg = JConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()})
    assert block_supported(cfg, qw) and jblock_supported(jcfg, {k: v for k, v in qw.items()})
    assert layer_routes(cfg, gl, qw, 4, 1, True, 1) == (True, True)
    assert layer_routes(dataclasses.replace(cfg, attn_bias=True), gl, qw, 4, 1, True, 1)[0] is False
    assert layer_routes(dataclasses.replace(cfg, attn_out_scale=0.9), gl, qw, 4, 1, True,
                        1)[0] is False


# --------------------------------------------------------------------- YaRN

def test_yarn_at_gpt_oss_values_matches_jax():
    """The port's rope at gpt-oss's YaRN (factor 32 over an original context
    of 4096, base 150000, 64 rotated dims, neox), the mscale folded into cos
    and sin, against the JAX rope_cache at positions up to 131071: max abs
    error < 1e-5 (f32 angles of the same products, cos/sin of two
    libraries). The ramp's corners are the JAX defaults (rope_yarn_low 1,
    high 4), which a GGUF does not set."""
    fields = dict(arch="gpt-oss", head_dim=64, rope_dim=64, rope_base=150000.0,
                  rope_scaling="yarn", rope_scale=32.0, rope_orig_ctx=4096, n_ctx_train=131072,
                  rope_type="neox")
    jcfg, cfg = JConfig(**fields), ModelConfig(**fields)
    assert (cfg.rope_yarn_low, cfg.rope_yarn_high) == (jcfg.rope_yarn_low,
                                                       jcfg.rope_yarn_high) == (1.0, 4.0)
    pos = np.concatenate([np.arange(64), np.random.default_rng(0).integers(0, 131072, 192)])
    pos = pos.reshape(2, 128).astype(np.int64)
    jc, js = (np.asarray(t) for t in jrope_cache(jcfg, jnp.asarray(pos, jnp.int32)))
    c, s = (t.numpy() for t in rope_cache(cfg, torch.from_numpy(pos)))
    assert np.abs(c - jc).max() < 1e-5 and np.abs(s - js).max() < 1e-5
    assert abs(float(np.abs(c[0, 0]).max()) - (0.1 * np.log(32) + 1)) < 1e-6  # mscale


# -------------------------------------------------- gpt-oss files, end to end

N_EMBD, N_LAYER, N_HEAD, N_KV, HEAD, N_EXP = 160, 3, 4, 2, 64, 4
WINDOW = 8


def _gpt_oss_gguf(path, swa_array, norm=None, seed=11):
    """A 3-layer gpt-oss MoE file at n_embd 160: 4 heads of 64 over 2 kv
    heads with q/k/v and output biases and per-head sinks, 4 MXFP4 experts
    of 160 (K 160: no K-major tile, so planar) top-2 with the router's bias
    and the gate, up and down biases, YaRN x32 over 4096 at base 150000, a
    window of 8 on the layers ``swa_array`` marks (None: no pattern key, as
    a published file), Q8_0 attention and lm_head, an SPM toy vocab of 256.
    ``norm``: an expert_weights_norm key, or none."""
    rng = np.random.default_rng(seed)
    rand = lambda *s, sc=0.05: (rng.standard_normal(s) * sc).astype(np.float32)
    a = "gpt-oss"
    w = GGUFWriter(path, arch=a)
    for key, val in (("context_length", 131072), ("embedding_length", N_EMBD),
                     ("block_count", N_LAYER), ("feed_forward_length", N_EMBD),
                     ("expert_feed_forward_length", N_EMBD), ("attention.head_count", N_HEAD),
                     ("attention.head_count_kv", N_KV), ("attention.key_length", HEAD),
                     ("attention.value_length", HEAD), ("rope.dimension_count", HEAD),
                     ("expert_count", N_EXP), ("expert_used_count", 2), ("vocab_size", 256),
                     ("attention.sliding_window", WINDOW),
                     ("rope.scaling.original_context_length", 4096)):
        w.add_uint32(f"{a}.{key}", val)
    w.add_float32(f"{a}.rope.freq_base", 150000.0)
    w.add_float32(f"{a}.attention.layer_norm_rms_epsilon", 1e-5)
    w.add_string(f"{a}.rope.scaling.type", "yarn")
    w.add_float32(f"{a}.rope.scaling.factor", 32.0)
    if swa_array is not None:
        w.add_array(f"{a}.attention.sliding_window_pattern", np.asarray(swa_array, np.uint32))
    if norm is not None:
        w.add_bool(f"{a}.expert_weights_norm", norm)
    add_spm_toy_vocab(w, 256)
    q8 = lambda name, arr: _add_quant_tensor(w, name, arr, GGMLType.Q8_0)
    q8("token_embd.weight", rand(256, N_EMBD))
    q8("output.weight", rand(256, N_EMBD))
    w.add_tensor("output_norm.weight", 1 + rand(N_EMBD))
    nq, nkv = N_HEAD * HEAD, N_KV * HEAD
    for i in range(N_LAYER):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", 1 + rand(N_EMBD))
        w.add_tensor(p + "ffn_norm.weight", 1 + rand(N_EMBD))
        q8(p + "attn_q.weight", rand(nq, N_EMBD))
        q8(p + "attn_k.weight", rand(nkv, N_EMBD))
        q8(p + "attn_v.weight", rand(nkv, N_EMBD))
        q8(p + "attn_output.weight", rand(N_EMBD, nq))
        for name, n in (("attn_q.bias", nq), ("attn_k.bias", nkv), ("attn_v.bias", nkv),
                        ("attn_output.bias", N_EMBD)):
            w.add_tensor(p + name, rand(n))
        w.add_tensor(p + "attn_sinks.weight", rand(N_HEAD, sc=2.0))
        w.add_tensor(p + "ffn_gate_inp.weight", rand(N_EXP, N_EMBD, sc=0.3))
        w.add_tensor(p + "ffn_gate_inp.bias", rand(N_EXP, sc=0.5))
        for name in ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"):
            _add_quant_tensor(w, p + name + ".weight", rand(N_EXP, N_EMBD, N_EMBD, sc=0.2),
                              GGMLType.MXFP4)
            w.add_tensor(p + name + ".bias", rand(N_EXP, N_EMBD, sc=0.5))
    w.write()
    return path


@pytest.fixture(scope="module")
def gpt_oss(tmp_path_factory):
    """{swa: (path, JAX config, params, result of PROMPTS)}: the per-layer
    array (1, 0, 1) and a file with no pattern."""
    out = {}
    d = tmp_path_factory.mktemp("gpt_oss")
    for name, arr in (("array", (1, 0, 1)), ("no_pattern", None)):
        path = _gpt_oss_gguf(str(d / f"{name}.gguf"), arr)
        jcfg, jparams, _ = jload(path)
        jr = JEngine(jcfg, jparams, max_seq_len=64, compute_dtype=jnp.float32,
                     decode_chunk=4).generate(PROMPTS, max_new_tokens=8, return_logits=True)
        out[name] = (path, jcfg, jparams, jr)
    return out


@pytest.mark.parametrize("swa", ["array", "no_pattern"])
def test_gpt_oss_file_generates_as_jax(gpt_oss, swa):
    """A gpt-oss MoE file through the port's loader and engine against the
    JAX engine, f32 on the CPU, 8 greedy tokens from prompts past the window
    of 8: the config field for field, first-step logits at NMSE < 1e-6 and
    identical tokens. The experts load as planar MXFP4 stacks with their f32
    biases; the sinks, the router's bias and the q/k/v/o biases as f32. A
    file without a pattern windows every layer, as the JAX parser does
    (swa_pattern 1; llama.cpp appears to window every other gpt-oss layer in
    code: ROADMAP §3). Without expert_weights_norm the routing weights are
    not renormalized (the JAX row sets no default; llama.cpp's gpt-oss
    appears to take a softmax over the selected logits)."""
    path, jcfg, jparams, jr = gpt_oss[swa]
    cfg, params, _ = load_model(path, device="cpu")
    fields = lambda c: {k: v for k, v in dataclasses.asdict(c).items() if k != "raw_kv"}
    assert fields(cfg) == fields(jcfg)
    assert cfg.act_fn == "swiglu_oai" and cfg.rope_scaling == "yarn" and cfg.attn_bias
    assert not cfg.expert_weights_norm
    assert layer_windows(cfg) == ([WINDOW, 0, WINDOW] if swa == "array" else [WINDOW] * 3)
    lay = params["layers"]
    assert {lay[k].layout for k in ("moe_gate_exps", "moe_up_exps", "moe_down_exps")} == {
        "planar"}
    assert lay["moe_gate_exps"].qtype == GGMLType.MXFP4
    for k, shape in (("attn_sinks", (3, N_HEAD)), ("moe_gate_inp_b", (3, N_EXP)),
                     ("moe_down_exps_b", (3, N_EXP, N_EMBD)), ("bo", (3, N_EMBD))):
        assert lay[k].dtype == torch.float32 and tuple(lay[k].shape) == shape, k
    r = InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                        decode_chunk=4, device="cpu").generate(
        PROMPTS, max_new_tokens=8, return_logits=True)
    assert _nmse(r.logits, jr.logits) < 1e-6, _nmse(r.logits, jr.logits)
    assert r.tokens == jr.tokens and all(len(t) == 8 for t in r.tokens)


def test_gpt_oss_ring_engine_matches_jax(gpt_oss):
    """The per-layer array's file on the iSWA ring (layers 0 and 2 in ring
    banks of window + chunk = 16 slots, layer 1 on the full banks) against
    the JAX iSWA engine: first-step logits at NMSE < 1e-10, the same
    greedy tokens."""
    path, jcfg, jparams, _ = gpt_oss["array"]
    cfg, params, _ = load_model(path, device="cpu")
    kw = dict(max_seq_len=64, decode_chunk=4, iswa=True, prefill_chunk=8)
    r = InferenceEngine(cfg, params, compute_dtype=torch.float32, device="cpu", **kw).generate(
        PROMPTS, max_new_tokens=8, return_logits=True)
    jr = JEngine(jcfg, jparams, compute_dtype=jnp.float32, **kw).generate(
        PROMPTS, max_new_tokens=8, return_logits=True)
    assert _nmse(r.logits, jr.logits) < 1e-10
    assert r.tokens == jr.tokens


def _serve(make, task_cls, params_cls, prompts, n_new=8):
    """Greedy tokens of each prompt through a started ServerContext."""
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


@pytest.mark.parametrize("kv", ["ring", "q8"])
def test_gpt_oss_server_matches_jax(gpt_oss, kv):
    """A ServerContext on the per-layer array's file, bf16 on the iSWA ring
    (the CLI's default: layers 0 and 2 in ring banks of window + chunk = 40
    slots, which the 50-token prompt wraps) and on the int8 full cache,
    against the JAX ServerContext's greedy tokens: three requests on two
    slots, prompts past the window. (The server pads a prefill chunk to at
    least 32 rows, so a ring below window + 32 slots would take padding
    rows over live ones, in both packages: ROADMAP §3.)"""
    path, jcfg, jparams, _ = gpt_oss["array"]
    cfg, params, _ = load_model(path, device="cpu")
    common = dict(n_slots=2, max_seq_len=128, decode_chunk=4, prefill_chunk=32,
                  iswa=kv == "ring", kv_dtype="q8" if kv == "q8" else None)
    prompts = PROMPTS[:2] + [list(range(3, 53))]
    got, ctx = _serve(lambda: ServerContext(cfg, params, None, compute_dtype=torch.float32,
                                            device="cpu", **common), Task, GenParams, prompts)
    want, _ = _serve(lambda: JServerContext(jcfg, jparams, None, compute_dtype=jnp.float32,
                                            **common), JTask, JGenParams, prompts)
    assert got == want and all(len(t) == 8 for t in got)
    assert ctx.memory.cache.dual == (kv == "ring")


def test_gpt_oss_expert_weights_norm_key(tmp_path):
    """With expert_weights_norm written (as chip_smoke's gpt-oss-20b phase
    writes it, for llama.cpp's routing) both parsers renormalize, and the
    two engines agree: NMSE < 1e-6, the same tokens."""
    path = _gpt_oss_gguf(str(tmp_path / "norm.gguf"), (1, 0, 1), norm=True)
    jcfg, jparams, _ = jload(path)
    cfg, params, _ = load_model(path, device="cpu")
    assert cfg.expert_weights_norm and jcfg.expert_weights_norm
    jr = JEngine(jcfg, jparams, max_seq_len=64, compute_dtype=jnp.float32,
                 decode_chunk=4).generate(PROMPTS[:1], max_new_tokens=4, return_logits=True)
    r = InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                        decode_chunk=4, device="cpu").generate(
        PROMPTS[:1], max_new_tokens=4, return_logits=True)
    assert _nmse(r.logits, jr.logits) < 1e-6 and r.tokens == jr.tokens


def test_mimo2_sinks_on_some_layers_match_jax(tmp_path, monkeypatch):
    """mimo2 with sinks on layers 0 and 2 only (its per-layer sinks,
    tpullm/models/registry.py:246-248): the loader splits the depth into
    groups by the key set, as the JAX loader stacks a key some layers carry,
    and the engine gives the JAX logits (NMSE < 1e-6) and tokens, with the
    value scale 0.9 on every layer's attention output."""
    add = GGUFWriter.add_tensor

    def drop_odd_sinks(self, name, *a, **kw):
        if name.endswith("attn_sinks.weight") and int(name.split(".")[1]) % 2:
            return None
        return add(self, name, *a, **kw)

    monkeypatch.setattr(GGUFWriter, "add_tensor", drop_odd_sinks)
    path = build_arch_gguf(str(tmp_path / "mimo2.gguf"), "mimo2", n_layer=4, seed=11)
    monkeypatch.undo()
    jcfg, jparams, _ = jload(path)
    cfg, params, _ = load_model(path, device="cpu")
    assert cfg.attn_out_scale == jcfg.attn_out_scale == pytest.approx(0.9)
    groups = params["layers"]["__groups__"]
    assert ["attn_sinks" in g for g in groups] == [True, False, True, False]
    jr = JEngine(jcfg, jparams, max_seq_len=64, compute_dtype=jnp.float32,
                 decode_chunk=4).generate(PROMPTS, max_new_tokens=8, return_logits=True)
    r = InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                        decode_chunk=4, device="cpu").generate(
        PROMPTS, max_new_tokens=8, return_logits=True)
    assert _nmse(r.logits, jr.logits) < 1e-6 and r.tokens == jr.tokens
