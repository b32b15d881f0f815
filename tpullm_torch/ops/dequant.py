"""Dequantization from planar arrays (the plain path of the planar layout).

Counterpart of tpullm/ops/dequant.py. The planar layout (quant/layout.py)
holds weights that the K-major kernels do not take: block types outside
KM_SPECS and rows too short for a K tile. Like the JAX package, which leaves
them to XLA, the port dequantizes the whole tensor and multiplies
(ops/qmm.py:qmm); no hand-written kernel reads this layout. It is ported for
Q8_0 only, the type of the small architecture fixtures
(tpullm/utils/synth.py:build_arch_gguf); every other planar type raises at
load (ops/qtensor.py). Numerics are bit-exact with
tpullm/ops/dequant.py:dequant_jax in float32.
"""
from __future__ import annotations

import torch

from ..gguf.constants import GGMLType

PLANAR_PORTED = frozenset({GGMLType.Q8_0})


def dequant_torch(planar: dict, qtype: GGMLType, dtype=torch.float32) -> torch.Tensor:
    """planar arrays (..., nb, ...) -> (..., nb*block) dense, in ``dtype``."""
    if GGMLType(qtype) not in PLANAR_PORTED:
        raise NotImplementedError(f"planar {GGMLType(qtype).name}: only Q8_0 is ported")
    y = planar["d"].to(torch.float32)[..., None] * planar["qs"].to(torch.float32)
    return y.reshape(*y.shape[:-2], y.shape[-2] * y.shape[-1]).to(dtype)
