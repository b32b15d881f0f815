"""Causal prefill attention with online softmax: kernel C.

Counterpart of tpullm/ops/flash_attention.py. The hand-written CUDA kernel
(csrc/flash_attention.cu) takes the place of its Pallas kernel; the plain
version is the masked softmax of the einsum path (tpullm/models/llama.py
attention, :295-360), which models/llama.py also uses as its own fallback.
On an iSWA ring bank (``ring``) both take the JAX ring mask (``ring_mask``,
llama.py:313-324) in place of the slot and window masks; the kernel reads
the ring by position (csrc/flash_attention.cu), where the JAX package sends
ring layers to its einsum path (llama.py:268). With ALiBi (a config's
``alibi_max_bias``) both add slope_h * (key position - query position) to
each score after the scale (llama.py:301-307); the kernel takes the slopes
(``alibi_of``) where the JAX package sends ALiBi to its einsum path
(llama.py:268-279). With attention sinks (gpt-oss, mimo2) the masked
softmax takes each head's sink as a key without a value (llama.py:342-348);
the kernel has no sink, so models/llama.py:attention_route keeps such calls
off it, as the JAX prefill gate does (``sinks is None``, llama.py:268).
With llama4's chunked window (``chunked``: a config's swa_chunked on a
window layer) both mask by chunk, a key visible where its position is at
least the query's floored to a multiple of the window (the JAX einsum
path, llama.py:335-337); the Pallas kernel masks such a layer as a sliding
window (flash_attention.py:61-64), so the port's C on it is its own route.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import _cuda

C_HEAD_DIMS = (128, 256)  # the kernel's instances (Dk = Dv; csrc/flash_attention.cu)


def alibi_slopes(n_head: int, max_bias: float) -> np.ndarray:
    """Per-head ALiBi slopes (tpullm/models/llama.py:361-368, the
    ggml_compute_forward_soft_max schedule): m0^(h+1) for the first n2 =
    2^floor(log2 H) heads, then m1^(2(h - n2) + 1)."""
    n2 = 1 << int(np.floor(np.log2(n_head)))
    m0 = 2.0 ** (-max_bias / n2)
    m1 = 2.0 ** (-(max_bias / 2.0) / n2)
    return np.asarray(
        [m0 ** (h + 1) if h < n2 else m1 ** (2 * (h - n2) + 1)
         for h in range(n_head)], np.float32)


def alibi_of(cfg, device):
    """The config's (H,) f32 ALiBi slopes on ``device``, or None without
    ALiBi."""
    if not cfg.alibi_max_bias > 0:
        return None
    return _slopes_on(cfg.n_head, float(cfg.alibi_max_bias), torch.device(device))


@functools.cache
def _slopes_on(n_head: int, max_bias: float, device: torch.device) -> torch.Tensor:
    """alibi_slopes on ``device``, made once: a copy from the host inside a
    CUDA graph capture would raise, and each layer's call would rebuild
    them."""
    return torch.tensor(alibi_slopes(n_head, max_bias), device=device)


def ring_mask(kv_slot, q_slot, valid_from, window: int, ring: int):
    """The JAX ring mask (llama.py:313-324), broadcast over its operands:
    ring slot j, seen from the query at slot q, holds the newest position
    cand <= q congruent to j modulo ring; visible where cand >= valid_from
    and q - cand < window (the ring itself with no window)."""
    cand = q_slot - torch.remainder(q_slot - kv_slot, ring)
    return (cand >= valid_from) & (q_slot - cand < (window or ring))


def masked_attention(q, k_all, v_all, q_slots, kv_positions, positions,
                     valid_from, scale: float, softcap: float = 0.0,
                     window: int = 0, ring: int = 0, slopes=None, sinks=None,
                     chunked: bool = False):
    """q (B,T,H,Dk), k/v HEAD-MAJOR (B,Hkv,S,D*) -> (B,T,H,Dv) in q's dtype.

    Key slot s is visible to the query at slot q_slots[b, t] iff
    valid_from[b] <= s <= q_slots[b, t] (and, with a window, its real
    position is within the window); on a ring bank (ring = S) by
    ``ring_mask``. GQA groups query heads by reshape. A row with no visible
    key outputs 0. ``slopes`` (H,): the ALiBi term slope_h * (kv_positions -
    positions), added after the scale and before the softcap. ``sinks``
    (H,): each head's sink logit joins the softmax as a key without a value,
    the max and the denominator taking it (llama.py:342-348). ``chunked``:
    the window is llama4's chunk, the key's position at least
    floor(q_pos / window) * window (llama.py:335-337), never on a ring."""
    B, T, H, Dk = q.shape
    Hkv, S = k_all.shape[1], k_all.shape[2]
    G = H // Hkv
    Dv = v_all.shape[-1]
    qf = q.reshape(B, T, Hkv, G, Dk).to(torch.float32)
    scores = torch.einsum("bthgd,bhsd->bhgts", qf, k_all.to(torch.float32))
    scores = scores * scale
    if slopes is not None:  # llama.py:301-307, by query head in the (Hkv, G) order
        delta = (kv_positions[:, None, None, None, :S].to(torch.float32)
                 - positions[:, None, None, :, None].to(torch.float32))
        scores = scores + slopes.to(torch.float32).reshape(1, Hkv, G, 1, 1) * delta
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    kv_slot = torch.arange(S, device=q.device)[None, None, None, None, :]
    q_slot = q_slots[:, None, None, :, None]
    vf = valid_from[:, None, None, None, None]
    if ring:
        mask = ring_mask(kv_slot, q_slot, vf, window, ring)
    else:
        mask = (kv_slot <= q_slot) & (kv_slot >= vf)
    if window and not ring:
        kv_pos = kv_positions[:, None, None, None, :]
        q_pos = positions[:, None, None, :, None]
        if chunked:
            mask = mask & (kv_pos >= torch.div(q_pos, window, rounding_mode="floor") * window)
        else:
            mask = mask & (kv_pos > q_pos - window)
    scores = scores.masked_fill(~mask, -math.inf)
    if sinks is not None:
        sk = sinks.to(torch.float32).reshape(1, Hkv, G, 1)
        m = torch.maximum(scores.amax(-1), sk)  # (B, Hkv, G, T)
        p = torch.exp(scores - m[..., None]).masked_fill(~mask, 0.0)
        probs = p / (p.sum(-1) + torch.exp(sk - m))[..., None]
    else:
        probs = torch.nan_to_num(torch.softmax(scores, dim=-1), nan=0.0)  # fully masked rows
    pm = probs.to(q.dtype).reshape(B, Hkv, G * T, S).to(torch.float32)
    out = torch.einsum("bhrs,bhsd->bhrd", pm, v_all.to(torch.float32))
    out = out.reshape(B, Hkv, G, T, Dv).permute(0, 3, 1, 2, 4)
    return out.reshape(B, T, H, Dv).to(q.dtype)


def attention_params(cfg, layer_is_swa: bool):
    """-> (scale, softcap, window) of the config (llama.py:296, :331)."""
    scale = cfg.attn_scale if cfg.attn_scale else 1.0 / math.sqrt(cfg.head_dim)
    window = cfg.sliding_window if layer_is_swa else 0
    return float(scale), float(cfg.attn_logit_softcap), int(window)


def _strides3(t: torch.Tensor, what: str):
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1]):
        raise ValueError(f"flash_attention {what}: last dim must be contiguous "
                         "and rows 16-byte aligned")
    return t.stride()[:-1]


def flash_attention(q, k_all, v_all, q_slots, kv_positions, positions,
                    valid_from, cfg, layer_is_swa: bool = False, ring: int = 0):
    """Same contract as masked_attention with the config's scale, softcap,
    window and ALiBi slopes: q (B,T,H,Dk), K/V head-major (B,Hkv,S,D*) ->
    (B,T,H,Dv) bf16. K/V are read in place from the cache layout. ``ring``
    (= S): an iSWA ring bank, whose query slots must be < ring - window
    apart in a call (a chunk of T <= ring - window rows). The kernel takes a
    key's position as its slot - valid_from (kv_positions as forward makes
    it) and ALiBi without a softcap; a window layer of a config with
    swa_chunked (llama4) masks by chunk, never on a ring."""
    scale, softcap, window = attention_params(cfg, layer_is_swa)
    chunked = bool(cfg.swa_chunked and window)
    B, T, H, Dk = q.shape
    Hkv, S = k_all.shape[1], k_all.shape[2]
    if ring and (ring != S or chunked):
        raise ValueError(f"flash_attention: a ring of {ring} over {S} slots"
                         + (", chunked" if chunked else ""))
    slopes = alibi_of(cfg, q.device)
    if not q.is_cuda:
        return masked_attention(q, k_all, v_all, q_slots, kv_positions, positions,
                                valid_from, scale, softcap, window, ring, slopes,
                                chunked=chunked)
    Dv = v_all.shape[-1]
    if Dk != Dv or Dk not in C_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention kernel: head dims {Dk}/{Dv}; {C_HEAD_DIMS} are built (Dk = Dv)")
    if (T % 64 and not ring) or S % 64 or H % Hkv:
        raise ValueError(f"flash_attention kernel: T={T} S={S} H={H} Hkv={Hkv} ring={ring}")
    qh = q.to(torch.bfloat16)
    kh = k_all.to(torch.bfloat16)
    vh = v_all.to(torch.bfloat16)
    out = torch.empty((B, T, H, Dv), dtype=torch.bfloat16, device=q.device)
    q_sb, q_st, q_sh = _strides3(qh, "q")
    k_sb, k_sh, k_ss = _strides3(kh, "k")
    v_sb, v_sh, v_ss = _strides3(vh, "v")
    o_sb, o_st, o_sh = out.stride()[:-1]
    i32 = [t.to(torch.int32).contiguous()
           for t in (q_slots, kv_positions[:, :S], positions, valid_from)]
    err = _cuda.lib().tpq_flash_attention(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(),
        *(t.data_ptr() for t in i32), B, H, Hkv, T, S, Dk,
        q_sb, q_sh, q_st, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_st,
        scale, softcap, window, int(chunked), int(ring),
        slopes.data_ptr() if slopes is not None else 0, _cuda.stream_ptr(qh))
    _cuda.COUNTS["flash_attention"] += 1
    _cuda.check(err, "flash_attention")
    return out


def flash_builds(T: int, S: int, Dk: int, Dv: int, H: int, Hkv: int, ring: int = 0,
                 chunked: bool = False) -> bool:
    """The shapes the CUDA kernel builds (the wrapper raises on the rest):
    Dk = Dv in C_HEAD_DIMS, T and S multiples of 64, H a multiple of Hkv; on
    a ring (S = ring a multiple of 64) any T >= 1. A chunked window
    (llama4) only over a plain view, never a ring."""
    return (Dk == Dv and Dk in C_HEAD_DIMS and T >= 1 and (ring or T % 64 == 0)
            and S % 64 == 0 and Hkv > 0 and H % Hkv == 0 and not (ring and chunked))


def flash_supported(T: int, S: int, Dk: int, Dv: int) -> bool:
    """The JAX package's gate as it is (flash_attention.py:170-172)."""
    return (T % 128 == 0 and S % 256 == 0 and Dk % 128 == 0 and Dv % 128 == 0
            and T >= 128)
