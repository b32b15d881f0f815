"""Dequantization from planar arrays (the plain path of the planar layout).

Counterpart of tpullm/ops/dequant.py. The planar layout (quant/layout.py)
holds weights that the K-major kernels do not take: block types outside
KM_SPECS and rows too short for a K tile. Like the JAX package, which leaves
them to XLA, the port dequantizes the whole tensor and multiplies
(ops/qmm.py:qmm); no hand-written kernel reads this layout. It is ported for
Q8_0, the type of the small architecture fixtures
(tpullm/utils/synth.py:build_arch_gguf), and Q4_K, which has no legal K
tile at K 768 (Qwen3-30B-A3B's down experts in a Q4_K file); every other
planar type raises at load (ops/qtensor.py). Numerics are bit-exact with
tpullm/ops/dequant.py:dequant_jax in float32.
"""
from __future__ import annotations

import torch

from ..gguf.constants import GGMLType


def _dq_q8_0(p):
    return p["d"].to(torch.float32)[..., None] * p["qs"].to(torch.float32)


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


_DEQUANT = {GGMLType.Q8_0: _dq_q8_0, GGMLType.Q4_K: _dq_q4_K}
PLANAR_PORTED = frozenset(_DEQUANT)


def dequant_torch(planar: dict, qtype: GGMLType, dtype=torch.float32) -> torch.Tensor:
    """planar arrays (..., nb, ...) -> (..., nb*block) dense, in ``dtype``."""
    qtype = GGMLType(qtype)
    if qtype not in PLANAR_PORTED:
        raise NotImplementedError(
            f"planar {qtype.name}: only {sorted(t.name for t in PLANAR_PORTED)} are ported")
    y = _DEQUANT[qtype](planar)
    return y.reshape(*y.shape[:-2], y.shape[-2] * y.shape[-1]).to(dtype)
