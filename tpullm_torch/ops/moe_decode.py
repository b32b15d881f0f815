"""Decode MoE over the selected experts only: kernel A's expert-skip variant.

Counterpart of the JAX decode MoE's ``lax.cond`` around each expert's
kernel-A calls (tpullm/models/llama.py:447-454): at B*T <= 16 an expert no
row selected is never read. A captured decode step cannot branch on the
routing from the host, so the branch moves onto the device:

- ``expert_slots`` lists the experts some row selected, ascending, padded
  with -1 to a fixed capacity min(E, rows * used), with torch ops on the
  device (no host read, so the step stays capturable);
- ``qmm_experts`` runs kernel A on every listed expert of an (L, E) K-major
  stack in one launch (csrc/qmm.cu ``qmm_experts_kernel``): one block
  column a (256-column tile, K slab, slot), a padded slot's blocks exiting
  at once, then a second pass writing each slot's product;
- ``experts_combine`` is the same launch for the down projection, whose
  second pass folds the slots into the MoE output in ascending expert order
  (``de * we``, then ``out + ...``, each rounded to the output type).

A's split plan and reduce order are kept per expert, so every listed
expert's product has the bits of A's call on it, and ``moe_decode`` equals
the all-expert loop of models/llama.py:moe_ffn bit for bit: an unselected
expert adds an exact 0 there. Bound on this card: the bytes of the selected
experts' weights (plus the f32 slabs the second pass reads).

The plain versions (``qmm_experts_plain``, ``experts_combine_plain``) are
the loop over the listed experts, reading the list back to the host; the
wrappers take them only for tensors on the CPU. On the card a wrapper
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..gguf.constants import GGMLType
from ..quant.kmajor import KM_SPECS
from . import _cuda
from .qmm import qmm_plain, qmm_supported, splitk_plan

MAX_ROWS = 16  # the decode rows the JAX gate skips experts at (B * T <= 16)
MAX_SLOTS = 384  # the combine's shared memory: 32 outputs x slots x 4 bytes <= 48 KB
_KEYS = ("q", "d", "s8", "m8", "dmin", "bm")


def skip_supported(qt, K: int, cap: int) -> bool:
    """The skip kernel's gate: an (L, E, ...) or (E, ...) K-major stack of a
    type kernel A takes, over at most MAX_SLOTS slots, cap = min(E, rows *
    used) (a planar stack, or any other weight, keeps the loop)."""
    if qt.layout != "kmajor" or qt.data["q"].dim() not in (3, 4):
        return False
    qtype = GGMLType(qt.qtype)
    return qtype in KM_SPECS and qmm_supported(qtype, K) and 1 <= cap <= MAX_SLOTS


def expert_slots(top_i, n_expert: int) -> torch.Tensor:
    """top_i (..., used) -> (cap,) int32 on its device: the experts any row
    selected, ascending, then -1; cap = min(n_expert, rows * used). Fixed
    shapes and no host read."""
    flat = top_i.reshape(-1).to(torch.int64)
    cap = min(n_expert, flat.numel())
    ar = torch.arange(n_expert, device=flat.device)
    hit = torch.zeros(n_expert, dtype=torch.bool, device=flat.device).index_fill_(0, flat, True)
    first = torch.sort(torch.where(hit, ar, ar + n_expert)).values[:cap]
    return torch.where(first < n_expert, first, -1).to(torch.int32)


def _expert(data: dict, layer, e: int) -> dict:
    return {k: (v[e] if layer is None else v[layer, e]) for k, v in data.items()}


def qmm_experts_plain(x, qt, layer, ids, out_dtype=torch.bfloat16):
    """Plain version of ``qmm_experts``: for each listed expert, x's rows
    (M, K) (or the slot's own, x (cap, M, K)) times it (qmm_plain); a padded
    slot's rows are 0. -> (cap, M, n_out)."""
    cap = ids.shape[0]
    M = x.shape[-2]
    out = torch.zeros((cap, M, qt.n_out), dtype=out_dtype, device=x.device)
    for slot, e in enumerate(ids.tolist()):
        if e < 0:
            break
        xs = x if x.dim() == 2 else x[slot]
        out[slot] = qmm_plain(xs, _expert(qt.data, layer, e), qt.qtype, qt.n_out, out_dtype)
    return out


def experts_combine_plain(h, qt, layer, ids, top_i, w, out_dtype=torch.bfloat16):
    """Plain version of ``experts_combine``: the loop over the listed
    experts, each slot's rows h[slot] (M, K) times its expert, weighted by
    the rows' routing weights of it (0 where a row did not select it) and
    added in order, as models/llama.py:moe_ffn's loop does. -> (M, n_out)."""
    M = h.shape[-2]
    out = torch.zeros((M, qt.n_out), dtype=out_dtype, device=h.device)
    for slot, e in enumerate(ids.tolist()):
        if e < 0:
            break
        de = qmm_plain(h[slot], _expert(qt.data, layer, e), qt.qtype, qt.n_out, out_dtype)
        we = (w * (top_i == e)).sum(-1)
        out = out + de * we[..., None].to(out_dtype)
    return out


def _launch(x, qt, layer, ids, out_dtype, combine):
    """Both wrappers' launch: kernel A's skip variant over the slots of ids,
    its second pass writing the slots' products (combine None) or folding
    them with combine = (top_i, w)."""
    qtype = GGMLType(qt.qtype)
    data = qt.data
    if (data["q"].dim() == 4) != (layer is not None):
        raise ValueError("qmm_experts: pass layer exactly for (L, E, ...) stacks")
    K, cap = x.shape[-1], ids.shape[0]
    if not skip_supported(qt, K, cap):
        raise NotImplementedError(
            f"qmm_experts: {qtype.name} {tuple(qt.shape)} at K={K} over {cap} slots is not a "
            f"stack the expert-skip kernel takes (at most {MAX_SLOTS} slots)")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"qmm_experts writes bf16 or f32, not {out_dtype}")
    M = x.shape[-2]
    if (x.dim() == 3 and x.shape[0] != cap) or M > MAX_ROWS or ids.dtype != torch.int32:
        raise ValueError(f"qmm_experts: x {tuple(x.shape)} and ids {tuple(ids.shape)} "
                         f"{ids.dtype} (int32 slots, rows <= {MAX_ROWS}, x shared or one a slot)")
    lay = data if layer is None else {k: v[layer] for k, v in data.items()}
    E = lay["q"].shape[0]
    x2 = x.to(torch.bfloat16).contiguous()
    for t, what in ((x2, "x"), (ids, "ids")):
        _cuda.require_cuda(t, f"qmm_experts {what}")
    args = _cuda.c_km([_cuda.km_descriptor({k: v[0] for k, v in lay.items()}, qtype, K)])
    es = (ctypes.c_longlong * 6)(*[
        lay[k].stride(0) * lay[k].element_size() if k in lay else 0 for k in _KEYS])
    Npad = lay["q"].shape[-1]
    gps, nS = splitk_plan(qtype, K, Npad)
    part = torch.empty((cap, nS, M, Npad), dtype=torch.float32, device=x.device)
    flag = 1 if out_dtype == torch.bfloat16 else 0
    if combine is None:
        out = torch.empty((cap, M, qt.n_out), dtype=out_dtype, device=x.device)
        rows = (0, 0, 0)
    else:
        top_i, w = (t.reshape(M, -1) for t in combine)
        top_i = top_i.to(torch.int64).contiguous()
        w = w.to(torch.float32).contiguous()
        for t, what in ((top_i, "top_i"), (w, "w")):
            _cuda.require_cuda(t, f"experts_combine {what}")
        out = torch.empty((M, qt.n_out), dtype=out_dtype, device=x.device)
        rows = (top_i.data_ptr(), w.data_ptr(), top_i.shape[1])
    err = _cuda.lib().tpq_qmm_experts(
        x2.data_ptr(), M * K if x.dim() == 3 else 0, M, K, *args, es, ids.data_ptr(), cap, E,
        part.data_ptr(), nS, gps, out.data_ptr(), qt.n_out, flag, *rows,
        0 if combine is None else 1, _cuda.stream_ptr(x2))
    _cuda.COUNTS["qmm_experts"] += 1
    _cuda.check(err, "qmm_experts")
    return out


def qmm_experts(x, qt, layer, ids, out_dtype=torch.bfloat16):
    """x (M, K), or (cap, M, K) one row set a slot, times each listed expert
    of the K-major stack qt (layer ``layer`` of (L, E, ...), or (E, ...)
    with layer None); ids from ``expert_slots``. -> (cap, M, n_out), a
    padded slot's rows 0. Kernel A's skip variant on the card, the plain
    version on the CPU."""
    if not x.is_cuda:
        return qmm_experts_plain(x, qt, layer, ids, out_dtype)
    return _launch(x, qt, layer, ids, out_dtype, None)


def experts_combine(h, qt, layer, ids, top_i, w, out_dtype=torch.bfloat16):
    """The down projection of the listed experts (h (cap, M, K), each
    slot's rows) folded into the MoE output (M, n_out): in slot order,
    out + de * we, we the rows' routing weights (w (M, used) f32) of the
    slot's expert where top_i (M, used) names it (summed where it names it
    twice, as grovemoe's chunk ids may), else 0. Kernel A's skip
    variant with its combining second pass on the card, the plain version
    on the CPU."""
    if not h.is_cuda:
        return experts_combine_plain(h, qt, layer, ids, top_i, w, out_dtype)
    return _launch(h, qt, layer, ids, out_dtype, (top_i, w))


def moe_decode(x, w, top_i, gate_w, up_w, down_w, layer, n_expert: int, dtype, act=None):
    """The routed experts of a decode step over the selected experts only:
    x (B, T, D), w and top_i (B, T, used) -> (B, T, D) in dtype, equal bit
    for bit to the all-expert loop (models/llama.py:moe_ffn) where every
    row's experts are among the listed ones, as they always are. ``act`` (g,
    u) -> h is the experts' gated activation (models/llama.py:gated_act:
    SiLU, or gpt-oss's swiglu_oai), SiLU where None. The kernels add no
    expert bias: a biased stack keeps the loop (models/llama.py:moe_route)."""
    B, T, D = x.shape
    M = B * T
    ids = expert_slots(top_i, n_expert)
    x2 = x.reshape(M, D)
    g = qmm_experts(x2, gate_w, layer, ids, dtype)
    u = qmm_experts(x2, up_w, layer, ids, dtype)
    if act is None:
        h = torch.nn.functional.silu(g.to(torch.float32)).to(dtype) * u
    else:
        h = act(g, u)
    out = experts_combine(h, down_w, layer, ids, top_i.reshape(M, -1), w.reshape(M, -1), dtype)
    return out.reshape(B, T, -1)


def partial_bytes(qt, K: int, M: int, cap: int) -> int:
    """Bytes of the f32 slabs one ``qmm_experts`` call writes (and its second
    pass reads): cap x nS x M x Npad x 4."""
    Npad = qt.data["q"].shape[-1]
    return cap * splitk_plan(GGMLType(qt.qtype), K, Npad)[1] * M * Npad * 4

