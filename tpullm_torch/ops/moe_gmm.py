"""Grouped (ragged) dequant-GEMM over routed experts: the MUL_MAT_ID prefill
kernel (megablocks-style).

Counterpart of tpullm/ops/moe_gmm.py. Tokens are SORTED by routed expert and
padded per expert to row tiles; each tile then multiplies its rows by
exactly ONE expert's K-major weights. Total work is sum_e round_up(count_e,
tile) rows, proportional to the actual assignments.

A hand-written CUDA kernel (kernel F, ``moe_gmm_kernel`` in
csrc/qmm_prefill.cu, kernel B's body behind an expert indirection) takes the
place of the Pallas kernel ``_build_gmm``. ``grouped_qmm`` launches it for
tensors on the card, or raises; for tensors on the CPU it runs the plain
version (``grouped_qmm_plain``). The bookkeeping (``sort_by_expert``) keeps
the JAX package's static row count, so no shape depends on the routing and
nothing is read back to the host. Its row tile is kernel F's, 256 rows (the
JAX package's is 128): one dequantized weight chunk then feeds 256 rows. A
row's product does not depend on the padding, so the MoE output is the
same at either tile.
"""
from __future__ import annotations

import math

import torch

from ..gguf.constants import GGMLType
from ..quant.kmajor import KM_SPECS, dequant_kmajor_torch
from . import _cuda
from .qmm import _pick_tile, pick_tile_k

TM = 256  # token-tile rows (one expert per tile): csrc/qmm_prefill.cu BM


def gmm_supported(qt, K: int) -> bool:
    """The JAX package's gate (moe_gmm.py:151-156): K-major, a legal K
    tile, N in 128-column tiles. Kernel F takes exactly these weights: a
    legal K tile holds whole groups of 8 scale groups of >= 16 elements a
    plane, so each plane of K is whole 64-deep chunks, as F requires."""
    if qt.layout != "kmajor" or qt.data["q"].dim() not in (3, 4):
        return False
    qtype = GGMLType(qt.qtype)
    return (qtype in KM_SPECS and pick_tile_k(qtype, K, cap=2048) > 0
            and _pick_tile(qt.data["q"].shape[-1], (512, 256, 128)) > 0)


def sort_by_expert(top_i, n_expert: int, n_rows: int, tm: int = TM):
    """top_i (M, used) -> ragged layout bookkeeping at row tiles of ``tm``
    (kernel F's 256 by default; the JAX package's 128 for parity).

    Returns (order (A,) source assignment per sorted position, dest (A,)
    padded row of each sorted assignment, tile_expert (nM,) int32, Mp). A =
    M*used; Mp = ceil(A/tm)*tm + E*tm (static worst-case padding).
    Per-expert counts are a one-hot sum rather than torch.bincount, whose
    CUDA version reads the largest id back to the host."""
    M, used = top_i.shape
    A = M * used
    E = n_expert
    Mp = (-(-A // tm) + E) * tm
    dev = top_i.device
    ef = top_i.reshape(-1).to(torch.int64)
    order = torch.argsort(ef, stable=True)
    ef_s = ef[order]
    counts = (ef[:, None] == torch.arange(E, device=dev)).sum(0)
    padded = (counts + tm - 1) // tm * tm
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    off = torch.cat([zero, torch.cumsum(padded, 0)])
    start = torch.cat([zero, torch.cumsum(counts, 0)])
    dest = off[ef_s] + (torch.arange(A, device=dev) - start[ef_s])
    # tile t (rows [t*tm, (t+1)*tm)) belongs to the expert whose padded
    # range contains it; tiles past the live range clamp to the last expert
    nM = Mp // tm
    tiles = torch.arange(nM, device=dev) * tm
    tile_expert = torch.searchsorted(off[1:].contiguous(), tiles, right=True)
    tile_expert = tile_expert.clamp(0, E - 1).to(torch.int32)
    return order, dest, tile_expert, Mp


def live_tiles(dest, tile_expert, Mp: int) -> torch.Tensor:
    """(1,) int32 on dest's device: the row tiles that hold an expert's
    rows. Every expert's range is whole tiles, so they are the tiles up to
    the one holding the largest destination row. The tile is read from the
    shapes (Mp rows in tile_expert's tiles)."""
    return (dest.max() // (Mp // tile_expert.numel()) + 1).to(torch.int32).reshape(1)


def grouped_qmm_plain(xs_pad, tile_expert, qt, n_logical: int, layer=None):
    """Plain version of kernel F: per expert, its rows times its weight
    dequantized to bf16 (as the kernel's tile is), f32-accumulated, bf16
    out (_build_gmm's out_shape). Tiles past the live range carry zero rows
    and come out 0. The row tile is read from the shapes, so the JAX
    package's 128-row bookkeeping runs here too."""
    data = qt.data if layer is None else {k: v[layer] for k, v in qt.data.items()}
    Mp = xs_pad.shape[0]
    row_expert = torch.repeat_interleave(tile_expert.to(torch.int64), Mp // tile_expert.numel())
    out = torch.zeros((Mp, n_logical), dtype=torch.bfloat16, device=xs_pad.device)
    for e in range(data["q"].shape[0]):
        rows = torch.nonzero(row_expert == e).reshape(-1)
        if rows.numel() == 0:
            continue
        w = dequant_kmajor_torch({k: v[e] for k, v in data.items()}, qt.qtype,
                                 torch.bfloat16)[:n_logical]
        y = torch.matmul(xs_pad[rows].to(torch.float32), w.to(torch.float32).t())
        out[rows] = y.to(torch.bfloat16)
    return out


def grouped_qmm(xs_pad, tile_expert, qt, n_logical: int, layer=None, live=None):
    """xs_pad (Mp, K) bf16 expert-sorted/padded rows; tile_expert (Mp/TM,)
    int32 expert of each TM-row tile (on the card another tile raises); qt
    a kmajor QTensor with leading (L?, E) axes; ``live`` an optional (1,)
    int32 count of live tiles (the rest are written as zeros without
    work). Returns (Mp, n_logical) bf16.

    On the card this launches kernel F or raises (no fallback); on the CPU
    it runs the plain version."""
    if not xs_pad.is_cuda:
        return grouped_qmm_plain(xs_pad, tile_expert, qt, n_logical, layer)
    Mp, K = xs_pad.shape
    if not gmm_supported(qt, K):
        raise NotImplementedError(
            f"grouped_qmm: {getattr(qt.qtype, 'name', qt.qtype)} {tuple(qt.shape)} "
            f"at K={K} is not a weight kernel F takes")
    data = qt.data
    if (data["q"].dim() == 4) != (layer is not None):
        raise ValueError("grouped_qmm: pass layer exactly for (L, E, ...) weights")
    if Mp % TM or tile_expert.shape != (Mp // TM,) or tile_expert.dtype != torch.int32:
        raise ValueError(f"grouped_qmm: kernel F's {TM}-row tiles: Mp={Mp} rows need "
                         f"{Mp // TM} int32 tile experts, got {tuple(tile_expert.shape)} "
                         f"{tile_expert.dtype}")
    E = data["q"].shape[-3]
    slots = math.prod(data["q"].shape[:-2])  # (L, E) or (E,) weights
    x = xs_pad.to(torch.bfloat16).contiguous()
    for t, what in ((x, "xs_pad"), (tile_expert, "tile_expert")):
        _cuda.require_cuda(t, f"grouped_qmm {what}")
    if live is not None:
        _cuda.require_cuda(live, "grouped_qmm live")
    args = _cuda.c_km([_cuda.km_descriptor(data, GGMLType(qt.qtype), K)])
    out = torch.empty((Mp, n_logical), dtype=torch.bfloat16, device=x.device)
    err = _cuda.lib().tpq_moe_gmm(
        x.data_ptr(), Mp, K, *args, tile_expert.data_ptr(),
        0 if live is None else live.data_ptr(), 0 if layer is None else int(layer), E, slots,
        out.data_ptr(), n_logical, _cuda.stream_ptr(x))
    _cuda.COUNTS["moe_gmm"] += 1
    _cuda.check(err, "moe_gmm")
    return out
