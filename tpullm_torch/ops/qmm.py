"""Fused dequant-matmul over K-major quantized weights: y = x @ dequant(W)^T.

Counterpart of tpullm/ops/qmm.py. Two hand-written CUDA kernels take the
place of its two Pallas kernels:

- kernel A, split-K decode GEMV (``_build_qmm_splitk``, csrc/qmm.cu), when
  the padded M is at most 32;
- kernel B, prefill GEMM on wgmma (``_build_qmm``, csrc/qmm_prefill.cu),
  for larger M.

The plain version (``qmm_plain``) dequantizes with ``dequant_kmajor_torch``
and multiplies with f32 accumulation, as qmm.py:461-469 does. A wrapper
takes it only for tensors on the CPU; for CUDA tensors it launches a kernel
or raises. Layer-stacked weights pass the layer's base pointer (a view, no
copy).
"""
from __future__ import annotations

import math

import torch

from ..gguf.constants import GGMLType
from ..quant.kmajor import KM_SPECS, dequant_kmajor_torch, dstore_for
from . import _cuda

DEF_TILE_N = 256
DEF_TILE_K = 2048
SPLITK_COLS = 256  # columns per split-K block (csrc/qmm.cu SK_COLS)
SPLITK_BLOCKS = 1056  # split-K grid target: 8 blocks per SM of an H100
SPLITK_MAX_ROWS = 256  # packed rows per K slab (bounds the x slab in smem)


def _pick_tile(total: int, candidates) -> int:
    for c in candidates:
        if total % c == 0:
            return c
    return 0


def _n_planes(spec) -> int:
    return 2 if spec.kind == "u4" else 1


def tile_k_ok(qtype: GGMLType, tk: int, K: int) -> bool:
    """The JAX package's K-tile legality rule (qmm.py:311-321), kept as
    the structural gate of which weights take the K-major layout."""
    spec = KM_SPECS[GGMLType(qtype)]
    P = _n_planes(spec)
    ds = dstore_for(spec, K)
    kq = tk // P
    if tk % P or kq % 8 or kq % ds or kq % spec.gs:
        return False
    return (kq // spec.gs) % 8 == 0 and (kq // ds) % 8 == 0


def min_tile_k(qtype: GGMLType, K: int | None = None) -> int:
    spec = KM_SPECS[GGMLType(qtype)]
    ds = dstore_for(spec, K) if K is not None else spec.dstore
    return _n_planes(spec) * 8 * max(ds, spec.gs)


def pick_tile_k(qtype: GGMLType, K: int, cap: int = DEF_TILE_K) -> int:
    """Largest legal K-tile dividing K under cap (0 if none)."""
    best = 0
    mt = min_tile_k(qtype, K)
    t = mt
    while t <= min(K, cap):
        if K % t == 0 and tile_k_ok(qtype, t, K):
            best = t
        t += mt
    return best


def qmm_supported(qtype: GGMLType, K: int) -> bool:
    t = GGMLType(qtype)
    if t not in KM_SPECS:
        return False
    return pick_tile_k(t, K) > 0


def _layer_data(data: dict, layer) -> dict:
    return data if layer is None else {k: v[layer] for k, v in data.items()}


def qmm_plain(x, data: dict, qtype: GGMLType, n_logical: int,
              out_dtype=torch.bfloat16, layer=None):
    """Plain version of kernels A and B: dequantize, then an f32-accumulated
    matmul, cast to out_dtype (qmm.py:461-469)."""
    w = dequant_kmajor_torch(_layer_data(data, layer), qtype, out_dtype)[:n_logical]
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32).t())
    return y.to(out_dtype)


def m_pad(M: int) -> int:
    """The JAX wrapper's row padding (qmm.py:368-373); kernel A serves
    M_pad <= 32, kernel B the rest."""
    mp = M if M >= 16 else 16
    if mp % 16:
        mp += 16 - mp % 16
    if mp > 256 and mp % 256:
        mp += 256 - mp % 256
    return mp


def splitk_plan(qtype: GGMLType, K: int, Npad: int) -> tuple[int, int]:
    """-> (scale groups per K slab, number of slabs) for kernel A: enough
    slabs for ~SPLITK_BLOCKS blocks, whole scale groups per slab."""
    spec = KM_SPECS[GGMLType(qtype)]
    G = K // _n_planes(spec) // spec.gs
    tiles = Npad // SPLITK_COLS
    want = max(1, math.ceil(SPLITK_BLOCKS / tiles))
    gps = max(1, min(G // want, SPLITK_MAX_ROWS // spec.gs))
    while G % gps:
        gps -= 1
    return gps, G // gps


def _out_flag(out_dtype) -> int:
    if out_dtype == torch.bfloat16:
        return 1
    if out_dtype == torch.float32:
        return 0
    raise ValueError(f"qmm kernels write bf16 or f32, not {out_dtype}")


def qmm_kmajor(x, data: dict, qtype: GGMLType, n_logical: int,
               out_dtype=torch.bfloat16, layer=None):
    """x (..., K) @ W^T for K-major kernel arrays; returns (..., n_logical).

    With ``layer`` (an int) the arrays are layer-stacked (L, ...) and the
    kernel reads that layer in place. x is cast to bf16 as the TPU kernel
    does (qmm.py:365)."""
    qtype = GGMLType(qtype)
    if not x.is_cuda:
        return qmm_plain(x, data, qtype, n_logical, out_dtype, layer)
    lead = tuple(x.shape[:-1])
    K = x.shape[-1]
    M = math.prod(lead)
    w = _layer_data(data, layer)
    if w["q"].dim() != 2:
        raise ValueError(f"qmm: weight arrays must be 2-D per layer, got {tuple(w['q'].shape)}")
    Npad = w["q"].shape[-1]
    if not _pick_tile(Npad, (512, DEF_TILE_N, 128)):
        raise ValueError(f"qmm: no tile for N={Npad}")
    args = _cuda.c_km([_cuda.km_descriptor(w, qtype, K)])
    x2 = x.reshape(M, K).to(torch.bfloat16).contiguous()
    _cuda.require_cuda(x2, "qmm x")
    out = torch.empty((M, n_logical), dtype=out_dtype, device=x.device)
    flag = _out_flag(out_dtype)
    lib = _cuda.lib()
    stream = _cuda.stream_ptr(x2)
    if m_pad(M) <= 32:
        gps, nS = splitk_plan(qtype, K, Npad)
        part = torch.empty((nS, M, Npad), dtype=torch.float32, device=x.device)
        err = lib.tpq_qmm_splitk(x2.data_ptr(), M, K, *args, part.data_ptr(), nS,
                                 gps, out.data_ptr(), n_logical, flag, stream)
        _cuda.COUNTS["qmm_splitk"] += 1
        _cuda.check(err, "qmm_splitk")
    else:
        err = lib.tpq_qmm(x2.data_ptr(), M, K, *args, out.data_ptr(), n_logical,
                          flag, stream)
        _cuda.COUNTS["qmm"] += 1
        _cuda.check(err, "qmm")
    return out.reshape(*lead, n_logical)


def qmm(x, qt, out_dtype=torch.bfloat16, layer=None):
    """x (..., n_in) @ W^T for a QTensor W (n_out, n_in): the fused kernels
    for K-major weights (plain version on the CPU); planar and float
    weights are dequantized whole and take the plain product, as the JAX
    package leaves them to XLA (qmm.py:461-469)."""
    if qt.layout == "kmajor":
        return qmm_kmajor(x, qt.data, qt.qtype, qt.n_out, out_dtype, layer)
    data = qt.data if layer is None else {k: v[layer] for k, v in qt.data.items()}
    w = type(qt)(qt.qtype, qt.shape[-2:], data).dequant(out_dtype)
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32).t())
    return y.to(out_dtype)
