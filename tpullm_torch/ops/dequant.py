"""Dequantization from planar arrays (the plain path of the planar layout).

Counterpart of tpullm/ops/dequant.py. The planar layout (quant/layout.py)
holds weights that the K-major kernels do not take: block types outside
KM_SPECS and rows too short for a K tile. Like the JAX package, which leaves
them to XLA, the port dequantizes the whole tensor and multiplies
(ops/qmm.py:qmm); no hand-written kernel reads this layout. It is ported for
Q8_0, the type of the small architecture fixtures
(tpullm/utils/synth.py:build_arch_gguf), Q4_K, which has no legal K tile
at K 768 (Qwen3-30B-A3B's down experts in a Q4_K file), MXFP4, which
has none at K 2880 (gpt-oss's experts), and Q5_0, llama.cpp's fallback for
Q4_K rows whose K is not a multiple of 256 (a Q4_K_M DeepSeek-V2-Lite
file's downs at K 1408 and 10944, a GroveMoE file's chunk downs at K 128),
and TQ2_0, which has none at K 2560 and 6912 (BitNet b1.58 2B-4T's every
projection); every other planar type raises at load (ops/qtensor.py). Numerics are bit-exact with
tpullm/ops/dequant.py:dequant_jax in float32.
"""
from __future__ import annotations

import torch

from ..gguf.constants import GGMLType
from ..quant.kmajor import LUT_MXFP4, f32_on_device


def _dq_q8_0(p):
    return p["d"].to(torch.float32)[..., None] * p["qs"].to(torch.float32)


def _dq_q5_0(p):
    """tpullm/ops/dequant.py:_dq_q5_0: d * (q - 16), q a 4-bit nibble (the 16
    low nibbles of a block before its 16 high ones) with its fifth bit from
    qh, the block's 32 bits little-endian in element order."""
    qs = p["qs"].to(torch.int32)
    qh = p["qh"].to(torch.int64)
    word = qh[..., 0] | (qh[..., 1] << 8) | (qh[..., 2] << 16) | (qh[..., 3] << 24)
    bits = (word[..., None] >> torch.arange(32, device=qh.device)) & 1
    q = (torch.cat([qs & 0xF, qs >> 4], dim=-1) | (bits.to(torch.int32) << 4)) - 16
    return p["d"].to(torch.float32)[..., None] * q.to(torch.float32)


def _dq_q4_K(p):
    """tpullm/ops/dequant.py:_dq_q4_K: 8 sub-blocks of 32, each d * sc * q -
    dmin * mn, with q in ggml's element order (4 chunks of 32 bytes, the low
    nibbles of a chunk then its high ones)."""
    qs = p["qs"].to(torch.int32)
    g = qs.reshape(*qs.shape[:-1], 4, 32)
    q = torch.cat([g & 0xF, g >> 4], dim=-1).reshape(*qs.shape[:-1], 256).to(torch.float32)
    d_sub = p["d"].to(torch.float32)[..., None] * p["sc"].to(torch.float32)
    m_sub = p["dmin"].to(torch.float32)[..., None] * p["mn"].to(torch.float32)
    return (torch.repeat_interleave(d_sub, 32, dim=-1) * q
            - torch.repeat_interleave(m_sub, 32, dim=-1))


def _dq_mxfp4(p):
    """tpullm/ops/dequant.py:155-161: the e8m0 byte e as the f32 of bits
    (e - 1) << 23 (half of 2^(e - 127), the LUT holding doubled values);
    each 4-bit code through KVALUES_MXFP4, the 16 low nibbles of a block
    before its 16 high ones. For e < 2 the JAX function makes the subnormal
    halves (bits 0x00200000 << e), which XLA reads as zero (its CPU and TPU
    backends flush subnormal operands): those blocks give +-0 there, and so
    here, where torch would keep the subnormals (llama.cpp's CPU keeps them
    too: values below 2^-124, ROADMAP §3)."""
    e = p["e"].to(torch.int32)
    d = torch.where(e < 2, torch.zeros_like(e), (e - 1) << 23).view(torch.float32)[..., None]
    lut = f32_on_device(LUT_MXFP4, e.device)
    qs = p["qs"].to(torch.int64)
    return d * torch.cat([lut[qs & 0xF], lut[qs >> 4]], dim=-1)


def _dq_tq2_0(p):
    """tpullm/ops/dequant.py:170 _dq_tq2_0: d * (t - 1), each byte's four
    2-bit trits t at shifts 0, 2, 4 and 6, in ggml's element order (each
    32-byte half of a block: its 32 bytes' shift-0 trits, then shift 2, 4
    and 6)."""
    q = p["qs"].to(torch.int32).reshape(*p["qs"].shape[:-1], 2, 32)
    grid = torch.stack([((q >> s) & 3) - 1 for s in (0, 2, 4, 6)], dim=-2)
    return p["d"].to(torch.float32)[..., None] * grid.reshape(
        *p["qs"].shape[:-1], 256).to(torch.float32)


_DEQUANT = {GGMLType.Q8_0: _dq_q8_0, GGMLType.Q4_K: _dq_q4_K, GGMLType.MXFP4: _dq_mxfp4,
            GGMLType.Q5_0: _dq_q5_0, GGMLType.TQ2_0: _dq_tq2_0}
PLANAR_PORTED = frozenset(_DEQUANT)


def dequant_torch(planar: dict, qtype: GGMLType, dtype=torch.float32) -> torch.Tensor:
    """planar arrays (..., nb, ...) -> (..., nb*block) dense, in ``dtype``."""
    qtype = GGMLType(qtype)
    if qtype not in PLANAR_PORTED:
        raise NotImplementedError(
            f"planar {qtype.name}: only {sorted(t.name for t in PLANAR_PORTED)} are ported")
    y = _DEQUANT[qtype](planar)
    return y.reshape(*y.shape[:-2], y.shape[-2] * y.shape[-1]).to(dtype)
