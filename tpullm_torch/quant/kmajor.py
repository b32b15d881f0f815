"""K-major kernel layout: the weight repack the fused dequant-matmul reads.

Copy of tpullm/quant/kmajor.py (numpy pack path only) plus
``dequant_kmajor_torch``, the counterpart of ``dequant_kmajor_jnp``.

Layout, per weight (n_out = N padded to Npad, contraction dim K):

    q   : (K/2, Npad) u8 two-nibble planes (kind "u4"), HALF-SPLIT: element
          k of column n is the lo nibble of row k for k < K/2 and the hi
          nibble of row k-K/2 otherwise; or (K, Npad) i8 (kind "i8").
    d   : (K/ds, Npad) f32, one row per ds = dstore_for(spec, K) elements
    s8  : (K/gs, Npad) i8 sub-scales (superblock kinds)
    m8  : (K/gs, Npad) i8 sub-mins + dmin (K/ds, Npad) f32 (bias "i8d")
    bm  : (K/gs, Npad) f32 direct bias (bias "f32")

    W[k, n] = (val(grid[k, n]) ) * scale[k//gs, n] + bias[k//gs, n]
    scale = s8 * d (sb set) or d; bias = -m8 * dmin or bm
    val = lut[u] (lut kinds) or u + off

N is the contiguous axis of q and of every metadata row, so a GPU kernel
whose neighbouring threads take neighbouring columns reads every array with
coalesced loads. Numerics match ggml dequantize_row_* with scales combined
in f32.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..gguf.constants import GGMLType
from .numpy_impl import KVALUES_IQ4NL, KVALUES_MXFP4

# 16-entry dequant LUTs (ggml-common.h kvalues_mxfp4 / kvalues_iq4nl)
LUT_MXFP4 = tuple(float(v) for v in KVALUES_MXFP4)
LUT_IQ4NL = tuple(float(v) for v in KVALUES_IQ4NL)


@dataclass(frozen=True)
class KmSpec:
    """Compact kernel layout descriptor (see the module docstring)."""

    kind: str  # "u4" | "i8"
    gs: int  # elements per scale group
    sb: int | None = None  # superblock size for d (None: d is per-gs)
    bias: str = "none"  # "none" | "f32" (bm plane) | "i8d" (m8 x dmin)
    off: float = 0.0  # constant integer offset folded in-kernel
    lut: tuple | None = None  # 16-entry dequant LUT (kind "u4" only)

    @property
    def dgs(self) -> int:
        return self.sb or self.gs

    @property
    def dstore(self) -> int:
        """Preferred storage granularity of d/dmin rows: one row per 128
        elements for superblock kinds, per gs otherwise. Use
        dstore_for(spec, K), which falls back to per-gs rows for small K."""
        return min(self.sb, 128) if self.sb else self.gs


def dstore_for(spec: "KmSpec", K: int) -> int:
    """Actual d/dmin row granularity for a tensor with contraction dim K."""
    P = 2 if spec.kind == "u4" else 1
    ds = spec.dstore
    if (K // P) % (8 * ds):
        ds = spec.gs
    return ds


KM_SPECS: dict[GGMLType, KmSpec] = {
    GGMLType.Q4_0: KmSpec("u4", 32, off=-8),
    GGMLType.Q4_1: KmSpec("u4", 32, bias="f32"),
    GGMLType.Q5_0: KmSpec("i8", 32, off=-16),
    GGMLType.Q5_1: KmSpec("i8", 32, bias="f32"),
    GGMLType.Q8_0: KmSpec("i8", 32),
    GGMLType.Q2_K: KmSpec("i8", 16, sb=256, bias="i8d"),
    GGMLType.Q3_K: KmSpec("i8", 16, sb=256),
    GGMLType.Q4_K: KmSpec("u4", 32, sb=256, bias="i8d"),
    GGMLType.Q5_K: KmSpec("i8", 32, sb=256, bias="i8d"),
    GGMLType.Q6_K: KmSpec("i8", 16, sb=256),
    GGMLType.IQ4_NL: KmSpec("u4", 32, lut=LUT_IQ4NL),
    GGMLType.IQ4_XS: KmSpec("u4", 32, sb=256, lut=LUT_IQ4NL),
    GGMLType.MXFP4: KmSpec("u4", 32, lut=LUT_MXFP4),
    GGMLType.TQ2_0: KmSpec("i8", 256),
}

KMAJOR_TYPES = frozenset(KM_SPECS)


def _f32(a):
    return np.asarray(a, np.float32)


def _nib(qs):
    return qs & 0xF, qs >> 4


def _grid_fields(planar: dict, qtype: GGMLType):
    """planar (N-major, ggml element order) -> (grid (N,K) int, fields).

    grid values are the kernel's stored integers: unsigned nibble index for
    "u4" kinds, signed int8 value for "i8". fields is the compact metadata
    {d f32 (N, K/dgs) [, s8 i8 (N, K/gs), m8 i8, dmin f32, bm f32]}."""
    t = GGMLType(qtype)
    if t in (GGMLType.Q4_0, GGMLType.Q4_1):
        lo, hi = _nib(planar["qs"])
        grid = np.concatenate([lo, hi], axis=-1)  # (N, nb, 32) unsigned 0..15
        f = {"d": _f32(planar["d"])}
        if t == GGMLType.Q4_1:
            f["bm"] = _f32(planar["m"])
        return _fl(grid), f
    if t in (GGMLType.Q5_0, GGMLType.Q5_1):
        lo, hi = _nib(planar["qs"])
        bits = _qh_bits32(planar["qh"])
        grid = (np.concatenate([lo, hi], axis=-1) | (bits << 4)).astype(np.int16)
        f = {"d": _f32(planar["d"])}
        if t == GGMLType.Q5_1:
            f["bm"] = _f32(planar["m"])
        return _fl(grid), f
    if t == GGMLType.Q8_0:
        return _fl(planar["qs"].astype(np.int16)), {"d": _f32(planar["d"])}
    if t == GGMLType.Q2_K:
        bits = _2bit_grid(planar["qs"])  # (N, nb, 256)
        scf = planar["sc"]  # (N, nb, 16) u8: lo nibble scale, hi nibble min
        return _fl(bits), {
            "d": _f32(planar["d"]), "dmin": _f32(planar["dmin"]),
            "s8": (scf & 0xF).astype(np.int8), "m8": (scf >> 4).astype(np.int8)}
    if t == GGMLType.Q3_K:
        bits = _2bit_grid(planar["qs"]).astype(np.int16)
        e = np.arange(256)
        hm = planar["hmask"][..., e % 32].astype(np.int16)
        hbit = (hm >> (e // 32)) & 1
        grid = bits - np.where(hbit == 1, 0, 4)
        return _fl(grid), {"d": _f32(planar["d"]),
                           "s8": planar["sc"].astype(np.int8)}
    if t == GGMLType.Q4_K:
        g = planar["qs"].reshape(*planar["qs"].shape[:-1], 4, 32)
        grid = np.concatenate([g & 0xF, g >> 4], axis=-1).reshape(
            *planar["qs"].shape[:-1], 256)
        return _fl(grid), {
            "d": _f32(planar["d"]), "dmin": _f32(planar["dmin"]),
            "s8": planar["sc"].astype(np.int8), "m8": planar["mn"].astype(np.int8)}
    if t == GGMLType.Q5_K:
        qs = planar["qs"].reshape(*planar["qs"].shape[:-1], 4, 32).astype(np.int16)
        qh = planar["qh"].astype(np.int16)[..., None, :]
        g = np.arange(4)[:, None]
        lob = (qh >> (2 * g)) & 1
        hib = (qh >> (2 * g + 1)) & 1
        grid = np.concatenate([(qs & 0xF) + 16 * lob, (qs >> 4) + 16 * hib], axis=-1)
        grid = grid.reshape(*planar["qs"].shape[:-1], 256)
        return _fl(grid), {
            "d": _f32(planar["d"]), "dmin": _f32(planar["dmin"]),
            "s8": planar["sc"].astype(np.int8), "m8": planar["mn"].astype(np.int8)}
    if t == GGMLType.Q6_K:
        ql = planar["ql"].reshape(*planar["ql"].shape[:-1], 2, 64).astype(np.int16)
        qh = planar["qh"].reshape(*planar["qh"].shape[:-1], 2, 32).astype(np.int16)
        q1 = ((ql[..., :32] & 0xF) | ((qh & 3) << 4)) - 32
        q2 = ((ql[..., 32:] & 0xF) | (((qh >> 2) & 3) << 4)) - 32
        q3 = ((ql[..., :32] >> 4) | (((qh >> 4) & 3) << 4)) - 32
        q4 = ((ql[..., 32:] >> 4) | (((qh >> 6) & 3) << 4)) - 32
        grid = np.concatenate([q1, q2, q3, q4], axis=-1).reshape(
            *planar["ql"].shape[:-1], 256)
        return _fl(grid), {"d": _f32(planar["d"]),
                           "s8": planar["sc"].astype(np.int8)}
    if t == GGMLType.IQ4_NL:
        lo, hi = _nib(planar["qs"])
        grid = np.concatenate([lo, hi], axis=-1)
        return _fl(grid), {"d": _f32(planar["d"])}
    if t == GGMLType.IQ4_XS:
        qs = planar["qs"].reshape(*planar["qs"].shape[:-1], 8, 16)
        grid = np.concatenate([qs & 0xF, qs >> 4], axis=-1).reshape(
            *planar["qs"].shape[:-1], 256)
        return _fl(grid), {"d": _f32(planar["d"]),
                           "s8": planar["sc"].astype(np.int8)}
    if t == GGMLType.TQ2_0:
        q = planar["qs"].reshape(*planar["qs"].shape[:-1], 2, 32).astype(np.int16)
        parts = [((q >> s) & 3) - 1 for s in (0, 2, 4, 6)]
        grid = np.stack(parts, axis=-2).reshape(*planar["qs"].shape[:-1], 256)
        return _fl(grid), {"d": _f32(planar["d"])}
    if t == GGMLType.MXFP4:
        lo, hi = _nib(planar["qs"])
        grid = np.concatenate([lo, hi], axis=-1)
        e = planar["e"].astype(np.uint32)
        bits = np.where(e < 2, np.uint32(0x00200000) << e, (e - 1) << 23)
        d = bits.view(np.float32).reshape(e.shape)
        return _fl(grid), {"d": _f32(d)}
    raise NotImplementedError(f"kmajor layout for {t.name}")


def _fl(a):
    """(N, nb, blk) -> (N, K) keeping element order."""
    return np.ascontiguousarray(a.reshape(a.shape[0], -1))


def _qh_bits32(qh):
    q = (
        qh[..., 0].astype(np.uint32)
        | (qh[..., 1].astype(np.uint32) << 8)
        | (qh[..., 2].astype(np.uint32) << 16)
        | (qh[..., 3].astype(np.uint32) << 24)
    )
    shifts = np.arange(32, dtype=np.uint32)
    return ((q[..., None] >> shifts) & 1).astype(np.uint8)


def _2bit_grid(qs):
    q = qs.reshape(*qs.shape[:-1], 2, 32)
    parts = [(q >> s) & 3 for s in (0, 2, 4, 6)]
    return np.stack(parts, axis=-2).reshape(*qs.shape[:-1], 256)


def pack_kmajor(planar: dict, qtype: GGMLType, n_pad_to: int = 256) -> dict[str, np.ndarray]:
    """Planar (N-major) arrays -> compact K-major kernel dict
    {q, d[, s8, m8, dmin, bm]} (see KmSpec for the decomposition).

    N is zero-padded to a multiple of ``n_pad_to`` (padded columns have zero
    scale so they dequantize to exactly 0 even for LUT kinds)."""
    spec = KM_SPECS[GGMLType(qtype)]
    grid, fields = _grid_fields(planar, qtype)
    N, K = grid.shape
    npad = (-N) % n_pad_to
    if npad:
        grid = np.pad(grid, ((0, npad), (0, 0)))
        fields = {k: np.pad(v.reshape(N, -1), ((0, npad), (0, 0)))
                  for k, v in fields.items()}
    ds = dstore_for(spec, K)
    out = {"q": _pack_transposed(grid, spec.kind)}
    for k, v in fields.items():
        v2 = np.asarray(v).reshape(v.shape[0], -1)
        if k in ("d", "dmin") and spec.dgs != ds:
            v2 = np.repeat(v2, spec.dgs // ds, axis=-1)
        if v2.dtype == np.int8:
            out[k] = np.ascontiguousarray(v2.T)
        else:
            out[k] = np.ascontiguousarray(np.asarray(v2, np.float32).T)
    return out


def _pack_transposed(grid: np.ndarray, kind: str) -> np.ndarray:
    """(Npad, K) int grid -> packed (K/2, Npad) u8 or (K, Npad) i8."""
    K = grid.shape[1]
    gt = np.ascontiguousarray(grid.T)
    if kind == "u4":
        return (gt[: K // 2] | (gt[K // 2:] << 4)).astype(np.uint8)
    return gt.astype(np.int8)


def unpack_grid_torch(q: torch.Tensor, kind: str) -> torch.Tensor:
    """Packed kernel quants -> integer grid (K, Npad) int32."""
    qi = q.to(torch.int32)
    if kind == "u4":
        # half-split planes: rows [0, K/2) = lo nibbles, [K/2, K) = hi
        return torch.cat([qi & 0xF, qi >> 4], dim=0)
    return qi


def scale_rows_torch(data: dict, spec: KmSpec):
    """Compact metadata -> (scale (K/gs, N) f32, bias (K/gs, N) f32 | None).

    The d granularity is read off the arrays (dstore_for at pack time), and
    d*s8 / -dmin*m8 are combined in f32 exactly as scale_rows_jnp does."""
    if spec.sb is not None:
        rep = data["s8"].shape[-2] // data["d"].shape[-2]
        scale = data["s8"].to(torch.float32) * torch.repeat_interleave(data["d"], rep, dim=-2)
    else:
        scale = data["d"]
    bias = None
    if spec.bias == "i8d":
        rep = data["m8"].shape[-2] // data["dmin"].shape[-2]
        bias = -(data["m8"].to(torch.float32)
                 * torch.repeat_interleave(data["dmin"], rep, dim=-2))
    elif spec.bias == "f32":
        bias = data["bm"]
    return scale, bias


@functools.cache
def f32_on_device(values: tuple, device: torch.device) -> torch.Tensor:
    """A constant's f32 copy on ``device``, made once: a copy from the host
    inside a CUDA graph capture (a captured decode step's embedding lookup
    or RoPE) would raise."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def dequant_kmajor_torch(data: dict, qtype: GGMLType, dtype) -> torch.Tensor:
    """Kernel arrays -> dense (Npad, K) weight (the plain path and oracle)."""
    spec = KM_SPECS[GGMLType(qtype)]
    grid = unpack_grid_torch(data["q"], spec.kind)  # (K, Npad) i32
    if spec.lut is not None:
        val = f32_on_device(spec.lut, grid.device)[grid]
    else:
        val = grid.to(torch.float32)
        if spec.off:
            val = val + spec.off
    scale, bias = scale_rows_torch(data, spec)
    w = val * torch.repeat_interleave(scale, spec.gs, dim=0)
    if bias is not None:
        w = w + torch.repeat_interleave(bias, spec.gs, dim=0)
    return w.t().to(dtype)  # (Npad, K)
