"""Store one layer's new K/V rows into the KV cache: the port's own kernel.

The JAX package's forward quantizes the new rows for the int8 cache
(``_kv_quant``, tpullm/models/llama.py:132-138) and writes them with a
dynamic_update_slice or a scatter (``_store``, llama.py:803-818, 896-910);
XLA fuses that into the step's program. csrc/kv_store.cu does the whole
store of a layer in one launch, K and V together: rows (B, T, Hkv, D) go to
bank[b0 + b, h, slot[b] + t], quantized with their row scales on the int8
cache; writes at or past the cache's end are dropped. On an iSWA ring bank
(``ring``: the bank's slot count) row t of a call lands at (slot[b] + t) %
ring and none is dropped (the JAX ``_store(..., wrap=True)``, llama.py:894,
913). It takes rows in bf16 or f32 and bf16, f32 or int8 banks; the wrapper
raises on anything else.

``kv_store_plain`` is the same function in plain PyTorch (``kv_quant``
and an indexed store). The wrapper takes it for tensors on the CPU only.
"""
from __future__ import annotations

import torch

from . import _cuda

KV_ROWS = {torch.bfloat16: 0, torch.float32: 1}  # K/V row dtypes the kernel takes
KV_BANKS = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}  # cache dtypes it writes


def kv_quant(x):
    """(..., D) -> (int8 values, (...) f32 scales), bit-exact with
    llama.py:132-138: scale = amax / 127, values round(x / scale) clipped to
    [-127, 127] (round half to even, as jnp.round). The division is by a
    tensor: on the card PyTorch divides by a Python scalar as a product with
    its reciprocal, which can differ from a true division in the last bit."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = amax / torch.full_like(amax, 127.0)
    pos = scale > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale, torch.ones_like(scale)),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(xf * inv[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _store_rows(bank, val, slot, b0: int, ring: int = 0) -> None:
    """val (B, T, Hkv[, D]) into bank (B_cache, Hkv, S[, D]) at
    [b0 + b, h, slot[b] + t] (modulo ``ring`` on a ring bank), dropping
    slots outside the cache."""
    B, T, Hkv = val.shape[:3]
    S = bank.shape[2]
    slots = slot.to(device=bank.device, dtype=torch.int64)[:, None] + torch.arange(
        T, device=bank.device)[None, :]
    if ring:
        slots = slots % ring
    bi, ti = ((slots >= 0) & (slots < S)).nonzero(as_tuple=True)
    heads = torch.arange(Hkv, device=bank.device)[None, :]
    bank[(bi + b0)[:, None], heads, slots[bi, ti][:, None]] = val[bi, ti].to(bank.dtype)


def kv_store_plain(k_bank, v_bank, k, v, slot, b0: int = 0, ks_bank=None,
                   vs_bank=None, ring: int = 0) -> None:
    """One layer's store in plain PyTorch, in place: k (B, T, Hkv, Dk) and v
    (B, T, Hkv, Dv) into the banks (B_cache, Hkv, S, D*) from each row's first
    slot ``slot`` (B,) at cache rows [b0, b0 + B); with int8 banks the rows
    are quantized (``kv_quant``) and their scales go to ks_bank / vs_bank
    (B_cache, Hkv, S). ``ring`` (the banks' S) makes them a ring: row t goes
    to slot (slot[b] + t) % ring."""
    if ks_bank is not None:
        (kq, ksc), (vq, vsc) = kv_quant(k), kv_quant(v)
        for bank, val in ((k_bank, kq), (v_bank, vq), (ks_bank, ksc), (vs_bank, vsc)):
            _store_rows(bank, val, slot, b0, ring)
        return
    _store_rows(k_bank, k, slot, b0, ring)
    _store_rows(v_bank, v, slot, b0, ring)


def kv_store_builds(k, v, k_bank, v_bank, quantized: bool) -> bool:
    """The operands the CUDA kernel takes (the wrapper raises on the rest):
    K/V rows in bf16 or f32 with their last dim contiguous; contiguous banks
    of bf16 or f32, or int8 with f32 scales; the same head count and head
    dims on both sides."""
    return (k.dtype in KV_ROWS and v.dtype == k.dtype and k.stride(-1) == 1
            and v.stride(-1) == 1 and k_bank.dtype in KV_BANKS
            and v_bank.dtype == k_bank.dtype and (k_bank.dtype == torch.int8) == quantized
            and k_bank.is_contiguous() and v_bank.is_contiguous()
            and k.shape[2] == k_bank.shape[1] == v.shape[2] == v_bank.shape[1]
            and k.shape[-1] == k_bank.shape[-1] and v.shape[-1] == v_bank.shape[-1])


def kv_store(k_bank, v_bank, k, v, slot, b0: int = 0, ks_bank=None, vs_bank=None,
             ring: int = 0) -> None:
    """``kv_store_plain``'s contract: on the card one launch of the CUDA
    kernel for K and V; on the CPU the plain version."""
    if not k.is_cuda:
        kv_store_plain(k_bank, v_bank, k, v, slot, b0, ks_bank, vs_bank, ring)
        return
    if ring and ring != k_bank.shape[2]:
        raise ValueError(f"kv_store: ring {ring} on banks of {k_bank.shape[2]} slots")
    q8 = ks_bank is not None
    if not kv_store_builds(k, v, k_bank, v_bank, q8):
        raise ValueError(
            f"kv_store kernel: rows {k.dtype} {tuple(k.shape)}/{tuple(v.shape)} into banks "
            f"{k_bank.dtype} {tuple(k_bank.shape)}/{tuple(v_bank.shape)}: not built")
    B, T, Hkv = k.shape[:3]
    if v.shape[:3] != (B, T, Hkv) or slot.shape != (B,) or not 0 <= b0 <= k_bank.shape[0] - B:
        raise ValueError(f"kv_store: rows {tuple(k.shape)}/{tuple(v.shape)}, slot "
                         f"{tuple(slot.shape)}, cache rows [{b0}, {b0 + B}) of "
                         f"{k_bank.shape[0]}")
    if slot.dtype != torch.int64 or not slot.is_cuda or not slot.is_contiguous():
        raise ValueError("kv_store: slot must be a contiguous int64 tensor on the card")
    if q8:
        for t, what in ((ks_bank, "ks"), (vs_bank, "vs")):
            if t.dtype != torch.float32 or not t.is_contiguous() or t.shape != k_bank.shape[:3]:
                raise ValueError(f"kv_store {what}: contiguous f32 {tuple(k_bank.shape[:3])} "
                                 "expected")
    err = _cuda.lib().tpq_kv_store(
        k.data_ptr(), v.data_ptr(), *k.stride()[:3], *v.stride()[:3], k_bank.data_ptr(),
        v_bank.data_ptr(), ks_bank.data_ptr() if q8 else 0, vs_bank.data_ptr() if q8 else 0,
        slot.data_ptr(), B, T, Hkv, k_bank.shape[2], k.shape[-1], v.shape[-1], int(b0),
        KV_ROWS[k.dtype], KV_BANKS[k_bank.dtype], int(ring), _cuda.stream_ptr(k))
    _cuda.COUNTS["kv_store"] += 1
    _cuda.check(err, "kv_store")
