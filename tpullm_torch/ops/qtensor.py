"""QTensor: a quantized weight as a dict of torch tensors.

Counterpart of tpullm/ops/qtensor.py. Logical shape (..., n_out, n_in)
row-major. Layouts:
- "kmajor": the fused-kernel layout of tpullm_torch.quant.kmajor, read
  in place by the hand-written dequant-matmul kernels (ops/qmm.py,
  ops/moe_gmm.py) and dequantized by ``dequant_kmajor_torch`` on the plain
  path; 3-D (E, n_out, n_in) expert weights are packed per expert and
  stacked on E;
- "planar": quant/layout.py's arrays, for weights the K-major kernels do
  not take (block types outside KM_SPECS, rows too short for a K tile);
  dequantized whole by ops/dequant.py before a plain matmul, as the JAX
  package leaves them to XLA. Ported for Q8_0, Q4_K and MXFP4 only: any other
  weight that would be planar raises;
- "dense": float weights ({"w": tensor}).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..gguf.constants import GGML_QUANT_SIZES, GGMLType
from ..quant.kmajor import KMAJOR_TYPES, dequant_kmajor_torch, pack_kmajor
from ..quant.layout import decode_planar
from .dequant import PLANAR_PORTED, dequant_torch

_FLOAT_TYPES = frozenset({GGMLType.F32, GGMLType.F16, GGMLType.BF16})


@dataclass
class QTensor:
    """Quantized (or plain) 2-D+ weight. shape is numpy order: (..., n_out, n_in)."""

    qtype: GGMLType
    shape: tuple[int, ...]
    data: dict[str, torch.Tensor]  # layout-specific arrays; {"w": tensor} for float types

    @property
    def is_quantized(self) -> bool:
        return self.qtype not in _FLOAT_TYPES

    @property
    def layout(self) -> str:
        if not self.is_quantized or "w" in self.data:
            return "dense"
        return "kmajor" if "q" in self.data and "d" in self.data else "planar"

    @property
    def n_out(self) -> int:
        return self.shape[-2] if len(self.shape) > 1 else 1

    @property
    def n_in(self) -> int:
        return self.shape[-1]

    @property
    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.data.values())

    def to(self, device) -> "QTensor":
        return QTensor(self.qtype, self.shape,
                       {k: v.to(device) for k, v in self.data.items()})

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        """Full dense materialization (the plain path)."""
        if self.layout == "dense":
            return self.data["w"].to(dtype)
        if self.layout == "planar":  # leading dims follow the leaves
            return dequant_torch(self.data, self.qtype, dtype)
        q = self.data["q"]
        if q.dim() > 2:  # stacked leaves: dequant each
            lead = tuple(q.shape[:-2])
            flat = {k: v.reshape((-1,) + tuple(v.shape[len(lead):]))
                    for k, v in self.data.items()}
            ws = [dequant_kmajor_torch({k: v[i] for k, v in flat.items()},
                                       self.qtype, dtype)[: self.n_out]
                  for i in range(flat["q"].shape[0])]
            return torch.stack(ws).reshape(lead + tuple(ws[0].shape))
        return dequant_kmajor_torch(self.data, self.qtype, dtype)[: self.n_out]

    def take_rows(self, idx: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
        """Gather rows by index, then dequantize only those (embedding
        lookup). kmajor stores rows as columns: a column gather + dequant."""
        if self.layout == "dense":
            return self.data["w"][idx].to(dtype)
        if self.layout == "planar":
            return dequant_torch({k: v[idx] for k, v in self.data.items()}, self.qtype, dtype)
        flat = idx.reshape(-1)
        sub = {k: v.index_select(1, flat) for k, v in self.data.items()}
        w = dequant_kmajor_torch(sub, self.qtype, dtype)  # (nidx, K)
        return w.reshape(*idx.shape, self.n_in)


def _choose_layout(qtype: GGMLType, shape: tuple[int, ...]) -> str:
    """The JAX package's rule (qtensor.py:117-127): K-major for 2-D weights
    and 3-D (E, n_out, n_in) experts whose type and row length the kernels
    take, planar otherwise."""
    from .qmm import qmm_supported

    if len(shape) in (2, 3) and qtype in KMAJOR_TYPES and qmm_supported(qtype, shape[-1]):
        return "kmajor"
    return "planar"


def qtensor_from_bytes(raw: np.ndarray, qtype: GGMLType, shape: tuple[int, ...]) -> QTensor:
    """Raw GGUF payload bytes -> host (CPU) QTensor: K-major where the
    fused kernels take the weight, planar otherwise."""
    qtype = GGMLType(qtype)
    if qtype == GGMLType.F32:
        w = raw.view(np.float32).reshape(shape)
        return QTensor(qtype, tuple(shape), {"w": torch.from_numpy(w.copy())})
    if qtype == GGMLType.F16:
        w = raw.view(np.float16).reshape(shape)
        return QTensor(qtype, tuple(shape), {"w": torch.from_numpy(w.copy())})
    if qtype == GGMLType.BF16:
        u = raw.view(np.uint16).astype(np.uint32) << 16
        w = u.view(np.float32).reshape(shape)
        return QTensor(qtype, tuple(shape), {"w": torch.from_numpy(w.copy())})
    layout = _choose_layout(qtype, tuple(shape))
    if layout == "planar" and qtype not in PLANAR_PORTED:
        raise NotImplementedError(
            f"{qtype.name} {tuple(shape)}: no K-major layout for this type and row "
            "length, and the planar layout is ported for "
            f"{' and '.join(sorted(t.name for t in PLANAR_PORTED))} only")
    blk, bs = GGML_QUANT_SIZES[qtype]
    row_bytes = shape[-1] // blk * bs
    lead = tuple(shape[:-1]) if len(shape) > 1 else (1,)
    planar = decode_planar(raw.reshape(*lead, row_bytes), qtype)
    if layout == "kmajor":
        if len(lead) == 1:
            data = pack_kmajor(planar, qtype)
        else:  # (E, n_out, n_in) experts: pack each slice, stack on E
            packed = [pack_kmajor({k: v[e] for k, v in planar.items()}, qtype)
                      for e in range(lead[0])]
            data = {k: np.stack([pe[k] for pe in packed]) for k in packed[0]}
    else:
        data = planar
    return QTensor(qtype, tuple(shape),
                   {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in data.items()})
