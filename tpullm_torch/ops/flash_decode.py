"""Decode attention over the head-major KV cache: kernel E.

Counterpart of tpullm/ops/flash_decode.py. The hand-written CUDA kernel
(csrc/flash_decode.cu) takes the place of its Pallas kernel: T <= 8 query
tokens per batch row against K/V (B, Hkv, S, D), bf16 or int8 with f32 row
scales (B, Hkv, S), read in place with their strides. Each batch row reads
only the slots up to its newest query slot (and from its window's start),
so a decode step over rows at different depths moves the bytes those rows
need, not the bucketed view's. On an iSWA ring bank (``ring``: S = ring
slots, position p at slot p % ring) a row's query at slot q reads the
positions [max(valid_from, q - window + 1), q], each at its ring slot: the
JAX ring mask (tpullm/models/llama.py:313-324) on kernel E, where the JAX
package sends ring layers to its einsum path (llama.py:277). A row's query
slots must be consecutive (first + t). With ALiBi (the config's
``alibi_max_bias``) each score gets slope_h * (key position - query
position) after the scale (llama.py:301-307), a key's position being its
slot - valid_from: on kernel E, where the JAX package sends ALiBi to its
einsum path (llama.py:277-279). Per-head sink logits (gpt-oss, mimo2) join
each row's denominator in the last merge. Head dim 64 (gpt-oss) is built
beside 128 and 256, bf16 and int8 on plain banks and bf16 on the ring: the
port's own route, as the JAX gate asks Dk % 128 == 0 (flash_decode.py:254)
and sends it to its einsum path (``flash_decode_own_supported``).
``flash_decode_builds`` says which shapes the kernel builds; the wrapper
raises on any other.

``flash_decode_plain`` is the same function in plain PyTorch: the TPU
kernel's arithmetic (f32 scores of bf16 or int8 operands, the K scale
folded into the scores and the V scale into the probabilities, p rounded to
bf16 before the PV product, a sink as a value-less key in the denominator)
over the slots up to the newest query slot. The wrapper takes it for
tensors on the CPU only.
"""
from __future__ import annotations

import math
import os

import torch

from . import _cuda
from .flash_attention import alibi_of, ring_mask

# slots per split of the CUDA kernel by K/V type (int8: True); it rejects any
# other split count (csrc/flash_decode.cu split_of)
E_CH = {False: 128, True: 256}
E_GRP = 8  # live splits a first-level merge of the kernel takes (csrc/flash_decode.cu)
E_RMAX = 64  # most query rows (G * T) per kv head the kernel takes
E_HEAD_DIMS = (64, 128, 256)  # head dims the kernel is built for (Dk = Dv)
# those of them the JAX gate refuses (Dk % 128 != 0): E takes them on the
# port's own route (flash_decode_own_supported)
E_OWN_HEAD_DIMS = (64,)
E_KV_DTYPES = (torch.bfloat16, torch.int8)
NEG = -1e30


def _scale_of(cfg, scale):
    if scale is not None:
        return float(scale)
    return float(cfg.attn_scale) if cfg.attn_scale else 1.0 / math.sqrt(cfg.head_dim)


def flash_decode_plain(q, k_all, v_all, q_slots, positions, valid_from, scale: float,
                       softcap: float = 0.0, window: int = 0, chunked: bool = False,
                       sinks=None, k_scales=None, v_scales=None, ring: int = 0,
                       slopes=None):
    """q (B,T,H,Dk), K/V head-major (B,Hkv,S,D*) bf16 or int8 [+ (B,Hkv,S)
    f32 scales] -> (B,T,H,Dv) bf16. Reads slots up to the newest query slot
    of the batch (one host read of its value); a ring bank (ring = S) whole,
    with the JAX ring mask. ``slopes`` (H,): the ALiBi term slope_h * ((slot
    - valid_from) - position), added after the scale and before the
    softcap."""
    B, T, H, Dk = q.shape
    Hkv, S = k_all.shape[1], k_all.shape[2]
    G, Dv = H // Hkv, v_all.shape[-1]
    hi = S if ring else min(S, int(q_slots.max()) + 1)
    R = G * T
    # query row r = g * T + t of kv head h is token t of query head h * G + g
    qr = (q.to(torch.bfloat16).float().reshape(B, T, Hkv, G, Dk)
          .permute(0, 2, 3, 1, 4).reshape(B, Hkv, R, Dk))
    k = k_all[:, :, :hi].float()
    v = v_all[:, :, :hi].float()
    sc = torch.matmul(qr, k.transpose(-1, -2))  # (B, Hkv, R, hi)
    if k_scales is not None:
        sc = sc * k_scales[:, :, None, :hi].float()
    sc = sc * scale
    dev = q.device
    kv_slot = torch.arange(hi, device=dev)
    row_slot = q_slots.repeat(1, G).reshape(B, 1, R, 1)  # r = g * T + t -> t
    row_pos = positions.repeat(1, G).reshape(B, 1, R, 1)
    vf = valid_from.reshape(B, 1, 1, 1)
    if slopes is not None:  # row r of kv head h: query head h * G + r // T
        row_sl = slopes.float().reshape(1, Hkv, G, 1).repeat_interleave(T, 2).reshape(
            1, Hkv, R, 1)
        sc = sc + row_sl * ((kv_slot - vf).float() - row_pos.float())
    if softcap:
        sc = torch.tanh(sc / softcap) * softcap
    if ring:
        mask = ring_mask(kv_slot, row_slot, vf, window, ring)
    else:
        mask = (kv_slot <= row_slot) & (kv_slot >= vf)
    if window and not ring:
        kv_pos = kv_slot - vf
        if chunked:
            mask = mask & (kv_pos >= torch.div(row_pos, window, rounding_mode="floor") * window)
        else:
            mask = mask & (kv_pos > row_pos - window)
    sc = torch.where(mask, sc, torch.full_like(sc, NEG))
    m = sc.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(sc - m), torch.zeros_like(sc))
    l = p.sum(-1, keepdim=True)
    if v_scales is not None:
        p = p * v_scales[:, :, None, :hi].float()
    acc = torch.matmul(p.to(torch.bfloat16).float(), v)  # (B, Hkv, R, Dv)
    if sinks is not None:
        sk = sinks.float().reshape(Hkv, G, 1).repeat_interleave(T, 1).reshape(1, Hkv, R, 1)
        m2 = torch.maximum(m, sk)
        l = l * torch.exp(m - m2) + torch.exp(sk - m2)
        acc = acc * torch.exp(m - m2)
    norm = torch.where(l > 0, 1.0 / torch.where(l > 0, l, torch.ones_like(l)),
                       torch.zeros_like(l))
    out = (acc * norm).reshape(B, Hkv, G, T, Dv).permute(0, 3, 1, 2, 4)
    return out.reshape(B, T, H, Dv).to(torch.bfloat16)


def n_splits(S: int, q8: bool, ring: int = 0) -> int:
    """The kernel's grid of splits over an S-slot view: ceil(S / E_CH[q8]);
    over a ring (S = ring) the splits a range of ring + 7 positions can
    touch (T <= 8 consecutive query slots)."""
    ch = E_CH[q8]
    return -(-(ring + 7) // ch) + 1 if ring else -(-S // ch)


def counters_per_row(S: int, q8: bool, ring: int = 0) -> int:
    """Arrival counters the kernel uses for one (batch row, kv head) over an
    S-slot view (or a ring): one for each group of E_GRP live splits (the
    live splits are a range of the NS = n_splits splits, so at most NS //
    E_GRP + 1 groups) and one for the groups."""
    return n_splits(S, q8, ring) // E_GRP + 2


_COUNTERS: dict = {}  # device index -> the buffer launches outside a scope use now
_HELD: list = []  # every such buffer made: a captured graph keeps the one it saw


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The arrival counters a launch needing ``n`` of them uses: the current
    thread's owner's (``_cuda.counters_scope``; too small raises), else one
    buffer a device. Each launch leaves them zero (the last block to arrive
    at a counter resets it). The device's buffer serves launches that run
    one at a time, on one stream; a launch that needs more than it holds
    makes a larger one (zero), and the old one stays alive, since a graph
    captured earlier points at it. Making or growing it inside a capture
    raises: the graph would own a buffer that eager launches share."""
    owned = _cuda.scoped_counters("flash_decode")
    if owned is not None:
        if owned.numel() < n:
            raise ValueError(f"flash_decode: {owned.numel()} arrival counters in scope, "
                             f"{n} needed")
        return owned
    key = device.index if device.index is not None else torch.cuda.current_device()
    t = _COUNTERS.get(key)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"flash_decode: the arrival counters would be made or grown to {n} during a "
                "CUDA graph capture; launch in an owner's counters_scope")
        t = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                         device=torch.device("cuda", key))
        _HELD.append(t)
    return t


def _kv_strides(t: torch.Tensor, what: str):
    """(batch, head, slot) element strides of a K or V view whose rows are
    contiguous and 16-byte aligned."""
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
            (s * t.element_size()) % 16 for s in t.stride()[:-1]):
        raise ValueError(f"flash_decode {what}: rows must be contiguous and 16-byte aligned")
    return t.stride()[:-1]


def _scale_strides(t: torch.Tensor, what: str):
    if t.dtype != torch.float32 or t.stride(-1) != 1:
        raise ValueError(f"flash_decode {what}: f32 with slot stride 1 expected")
    return t.stride()[:-1]


def flash_decode(q, k_all, v_all, q_slots, positions, valid_from, cfg, window: int = 0,
                 sinks=None, scale=None, k_scales=None, v_scales=None, ring: int = 0):
    """q (B,T,H,Dk), k/v HEAD-MAJOR (B,Hkv,S,D*) [+ (B,Hkv,S) scales when
    int8] -> (B,T,H,Dv) bf16. Same masking contract as
    models.llama.attention: valid_from[b] <= slot <= q_slots[b, t], a window
    on the positions slot - valid_from (chunked with cfg.swa_chunked); on a
    ring bank (ring = S) the ring mask (``ring_mask``); the config's ALiBi
    slopes (``alibi_of``), without a softcap on the card."""
    scale = _scale_of(cfg, scale)
    softcap = float(cfg.attn_logit_softcap)
    chunked = bool(cfg.swa_chunked and window)
    if (k_scales is None) != (v_scales is None):
        raise ValueError("flash_decode: k_scales and v_scales go together")
    B, T, H, Dk = q.shape
    Hkv, S = k_all.shape[1], k_all.shape[2]
    if ring and (ring != S or chunked or k_scales is not None):
        raise ValueError(f"flash_decode: a ring of {ring} over {S} slots"
                         + (", chunked" if chunked else "")
                         + (", int8" if k_scales is not None else ""))
    slopes = alibi_of(cfg, q.device)
    if not q.is_cuda:
        return flash_decode_plain(q, k_all, v_all, q_slots, positions, valid_from, scale,
                                  softcap, window, chunked, sinks, k_scales, v_scales, ring,
                                  slopes)
    Dv = v_all.shape[-1]
    q8 = k_scales is not None
    if Dk != Dv or Dk not in E_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_decode kernel: head dims {Dk}/{Dv}; {E_HEAD_DIMS} are built (Dk = Dv)")
    want = torch.int8 if q8 else torch.bfloat16
    if k_all.dtype != want or v_all.dtype != want:
        raise ValueError(f"flash_decode kernel: K/V {k_all.dtype}/{v_all.dtype}, "
                         f"expected {want}")
    if not _rows_built(T, H, Hkv):
        raise ValueError(f"flash_decode kernel: H={H} Hkv={Hkv} T={T}")
    qh = q.to(torch.bfloat16).contiguous()
    k_sb, k_sh, k_ss = _kv_strides(k_all, "k")
    v_sb, v_sh, v_ss = _kv_strides(v_all, "v")
    ks_sb = ks_sh = vs_sb = vs_sh = 0
    if q8:
        ks_sb, ks_sh = _scale_strides(k_scales, "k_scales")
        vs_sb, vs_sh = _scale_strides(v_scales, "v_scales")
    sk = None
    if sinks is not None:
        sk = sinks.to(torch.float32).contiguous()
    # int64 as the model passes them: no conversion launches on the path
    i64 = [t.to(torch.int64).contiguous() for t in (q_slots, positions, valid_from)]
    NS = n_splits(S, q8, ring)
    R = (H // Hkv) * T
    part_ml = torch.empty((B, Hkv, NS, R, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, Hkv, NS, R, Dk), dtype=torch.float32, device=q.device)
    out = torch.empty((B, T, H, Dv), dtype=torch.bfloat16, device=q.device)
    err = _cuda.lib().tpq_flash_decode(
        qh.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
        k_scales.data_ptr() if q8 else 0, v_scales.data_ptr() if q8 else 0,
        sk.data_ptr() if sk is not None else 0, *(t.data_ptr() for t in i64),
        part_ml.data_ptr(), part_acc.data_ptr(),
        _counters(q.device, B * Hkv * counters_per_row(S, q8, ring)).data_ptr(),
        out.data_ptr(),
        B, T, H, Hkv, S, NS, Dk, int(q8), k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
        ks_sb, ks_sh, vs_sb, vs_sh, scale, softcap, int(window), int(chunked),
        int(sk is not None), int(ring), slopes.data_ptr() if slopes is not None else 0,
        _cuda.stream_ptr(qh))
    _cuda.COUNTS["flash_decode"] += 1
    _cuda.check(err, "flash_decode")
    return out


def _rows_built(T: int, H: int, Hkv: int) -> bool:
    return 1 <= T <= 8 and Hkv > 0 and H % Hkv == 0 and (H // Hkv) * T <= E_RMAX


def flash_decode_builds(T: int, Dk: int, Dv: int, H: int, Hkv: int, kv_dtype) -> bool:
    """The shapes the CUDA kernel builds (the wrapper raises on the rest):
    Dk = Dv in E_HEAD_DIMS (64, 128, 256), 1 <= T <= 8, H a multiple of Hkv with G * T <=
    E_RMAX query rows per kv head, bf16 or int8 K/V."""
    return (Dk == Dv and Dk in E_HEAD_DIMS and _rows_built(T, H, Hkv)
            and kv_dtype in E_KV_DTYPES)


def _jax_dims(T: int, Dk: int, Dv: int) -> bool:
    """The JAX gate's conditions on T and the head dims (flash_decode.py:
    250-255), under TPULLM_FLASH_DECODE: T <= 8, head dims multiples of 128
    up to 512."""
    return (bool(os.environ.get("TPULLM_FLASH_DECODE")) and T <= 8 and Dk % 128 == 0
            and Dv % 128 == 0 and Dk <= 512 and Dv <= 512)


def _own_dims(T: int, Dk: int, Dv: int) -> bool:
    """The port's own head dims (E_OWN_HEAD_DIMS), under
    TPULLM_FLASH_DECODE, T <= 8."""
    return (bool(os.environ.get("TPULLM_FLASH_DECODE")) and T <= 8 and Dk == Dv
            and Dk in E_OWN_HEAD_DIMS)


def flash_decode_ring_supported(T: int, Dk: int, Dv: int) -> bool:
    """The port's gate for a call on an iSWA ring bank, where the JAX
    package's gate says no (``not ring``, llama.py:277): flash_decode_supported
    less its conditions on the view's slot count, which a ring (window +
    chunk slots) need not meet: off unless TPULLM_FLASH_DECODE is set, then
    T <= 8 and head dims multiples of 128 up to 512, or the port's own head
    dim 64."""
    return _jax_dims(T, Dk, Dv) or _own_dims(T, Dk, Dv)


def flash_decode_supported(B: int, T: int, S: int, Dk: int, Dv: int, Hkv: int) -> bool:
    """The JAX package's gate as it is (flash_decode.py:243-255): off unless
    TPULLM_FLASH_DECODE is set, then T <= 8, S a multiple of 256, head dims
    multiples of 128 up to 512."""
    return _jax_dims(T, Dk, Dv) and S % 256 == 0 and S >= 256


def flash_decode_own_supported(B: int, T: int, S: int, Dk: int, Dv: int, Hkv: int) -> bool:
    """The port's own gate for head dim 64 (gpt-oss), which the JAX gate
    refuses (Dk % 128, flash_decode.py:254): its other conditions as they
    are (TPULLM_FLASH_DECODE, T <= 8, S a multiple of 256) with Dk = Dv in
    E_OWN_HEAD_DIMS."""
    return _own_dims(T, Dk, Dv) and S % 256 == 0 and S >= 256
