"""Slot-based KV memory for the serving engine.

Counterpart of tpullm/runtime/memory.py: one preallocated device KV cache
(L, n_slots, Hkv, S_max, D) whose batch rows are the slots (slot ==
sequence), with host-side metadata (lengths and token history). Admitting a
sequence is a host-side free-slot pop; the cache is updated in place.

Sequence ops: truncate (seq_rm p0..), clear, prefix reuse (the longest
common prefix with the slot's previous content), copy_slot (seq_cp), and
context_shift (seq_rm + seq_add with K re-roped by the shift, on the
device, dequantizing and requantizing an int8 cache; on a model without
RoPE the rows only move, as llama.cpp shifts K only when the rope type is
not NONE, where the JAX package rotates them all the same; on an MLA cache
only K's k_pe tail is rotated, where the JAX package rotates c_kv's head).
With ``iswa`` the SWA layers keep a ring of window + ``max_chunk`` slots
(the dual cache, llama_kv_cache_iswa): a prefix is reused only while the
ring still holds its window, and context_shift refuses (the server
reprocesses instead).
Saving and restoring slots and whole-context state are not ported yet and
raise.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..models.config import ModelConfig
from ..models.llama import KVCache, _kv_quant, apply_rope, nope_flags, rope_angles, rope_cache


@dataclass
class SlotState:
    n_past: int = 0  # tokens currently materialized in the cache
    tokens: list = field(default_factory=list)  # token history (prompt + generated)

    def clear(self):
        self.n_past = 0
        self.tokens = []


_NOT_PORTED = "slot and state save/restore are not ported to tpullm_torch yet"


class SlotMemory:
    """Host bookkeeping + device KV cache for n_slots sequences."""

    def __init__(self, cfg: ModelConfig, n_slots: int, max_seq_len: int,
                 kv_dtype=torch.bfloat16, device="cuda", iswa: bool = False,
                 max_chunk: int = 0):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq_len = max_seq_len
        self.cache = KVCache.create(cfg, n_slots, max_seq_len, kv_dtype, device,
                                    iswa=iswa, max_chunk=max_chunk)
        self.slots = [SlotState() for _ in range(n_slots)]

    def prefix_match(self, slot: int, tokens: list[int]) -> int:
        """Longest reusable prefix of ``tokens`` already in the slot's
        cache; leaves at least one token to decode so logits exist."""
        st = self.slots[slot]
        n = 0
        limit = min(st.n_past, len(tokens) - 1)
        hist = st.tokens
        while n < limit and n < len(hist) and hist[n] == tokens[n]:
            n += 1
        if n and self.cache.dual:
            # the ring's validity (memory.py:71-79): continuing from n reads
            # the SWA window's rows [n - W, n); the row of position p lasts
            # only while no position p + ring has been written
            oldest = max(0, n - self.cfg.sliding_window)
            if oldest + self.cache.ring < st.n_past:
                return 0
        return n

    def truncate(self, slot: int, n_keep: int):
        """seq_rm(slot, n_keep, -1): drop cached tokens >= n_keep."""
        st = self.slots[slot]
        st.n_past = min(st.n_past, n_keep)
        st.tokens = st.tokens[:n_keep]

    def clear_slot(self, slot: int):
        self.slots[slot].clear()

    def copy_slot(self, src: int, dst: int):
        """seq_cp of a whole sequence: cache rows dst <- src and metadata."""
        c = self.cache
        for buf in (c.k, c.v, c.ks, c.vs, c.kw, c.vw):
            if buf is not None:
                buf[:, dst] = buf[:, src]
        self.slots[dst].n_past = self.slots[src].n_past
        self.slots[dst].tokens = list(self.slots[src].tokens)

    def save_slot(self, slot: int) -> dict:
        raise NotImplementedError(_NOT_PORTED)

    def load_slot(self, slot: int, blob: dict) -> int:
        raise NotImplementedError(_NOT_PORTED)

    def save_slot_file(self, slot: int, path: str):
        raise NotImplementedError(_NOT_PORTED)

    def load_slot_file(self, slot: int, path: str) -> int:
        raise NotImplementedError(_NOT_PORTED)

    def save_state(self) -> dict:
        raise NotImplementedError(_NOT_PORTED)

    def load_state(self, blob: dict) -> None:
        raise NotImplementedError(_NOT_PORTED)

    def save_state_file(self, path: str) -> None:
        raise NotImplementedError(_NOT_PORTED)

    def load_state_file(self, path: str) -> None:
        raise NotImplementedError(_NOT_PORTED)

    def context_shift(self, slot: int, n_keep: int, n_discard: int):
        """Discard tokens [n_keep, n_keep + n_discard); roll the tail left and
        re-rope the moved K rows by -n_discard (on the device; without RoPE
        the rows move as they are)."""
        st = self.slots[slot]
        n_past = st.n_past
        assert n_keep + n_discard <= n_past
        if self.cache.dual:
            # a ring row's slot is its position modulo ring: a shift moves
            # every kept position, so the ring cannot be rolled in place
            # (memory.py:245-250); the server reprocesses the kept tokens
            raise RuntimeError("context_shift unsupported on an iSWA cache")
        _context_shift(self.cache, self.cfg, slot, n_keep, n_discard, n_past)
        st.tokens = st.tokens[:n_keep] + st.tokens[n_keep + n_discard:]
        st.n_past = n_past - n_discard


@torch.inference_mode()
def _context_shift(cache: KVCache, cfg: ModelConfig, slot: int, n_keep: int,
                   n_discard: int, n_past: int):
    """Roll rows [n_keep + nd, n_past) of one slot to [n_keep, n_past - nd)
    and rotate the moved K rows by the RoPE angle of -nd (memory.py:270-334,
    in place). The slot is taken seq-major (L, S, Hkv, D) for the roll. As
    in the JAX package, the K rows are rounded to bf16 for the rotation, and
    an int8 cache is dequantized, shifted and requantized whole.

    A model without RoPE (use_rope off: learned positions, ALiBi) has K
    rows that carry no position, so the rows of every bank (and an int8
    cache's row scales) move bit for bit and nothing is rotated, as
    llama.cpp does (K is shifted only when the rope type is not NONE). The
    JAX package rotates them all the same (memory.py:301-311: rope_cache
    never reads use_rope), which corrupts K on such a model: a departure
    from the reference (ROADMAP §3). An MLA cache shifts by ``_mla_shift``.

    The iRoPE decoders' NoPE layers (``nope_flags``: llama4, smallthinker,
    afmoe) hold K rows without a position too: their moved rows move
    unrotated (requantized as they were on the int8 cache) while the roped
    layers' rotate, as llama.cpp shifts only the layers it ropes. The JAX
    shift rotates every layer's K (memory.py:301-311), the NoPE layers' as
    well: the same departure (ROADMAP §3).

    A shared-KV cache (gemma4, gemma3n) holds banks for its first
    n_layer_kv_from_start layers alone; bank i is layer i's, and the shared
    layers read two of them, so each bank shifts as its owning layer's. As
    in the JAX shift, every bank rotates at rope_base, the SWA layers'
    (rope_base_swa) too (ROADMAP §3)."""
    S = cache.max_len
    dev = cache.k.device
    idx = torch.arange(S, device=dev)
    moved = (idx >= n_keep) & (idx < n_past - n_discard)
    src = torch.where(moved, idx + n_discard, idx)
    if cfg.kv_lora_rank:
        _mla_shift(cache, cfg, slot, src, moved, n_discard)
        return
    if not cfg.use_rope:
        for buf in (cache.k, cache.v, cache.ks, cache.vs):
            if buf is not None:  # head-major (L, B, Hkv, S[, D]): the slot's rows by src
                buf[:, slot] = buf[:, slot][:, :, src]
        return
    k_slot = cache.k[:, slot].transpose(1, 2)  # (L, S, Hkv, D)
    v_slot = cache.v[:, slot].transpose(1, 2)
    if cache.quantized:
        ks = cache.ks[:, slot].transpose(1, 2)[:, src]  # (L, S, Hkv)
        vs = cache.vs[:, slot].transpose(1, 2)[:, src]
        k_slot, v_slot = k_slot.to(torch.float32), v_slot.to(torch.float32)
    k_rolled = k_slot[:, src]
    v_rolled = v_slot[:, src]
    if cache.quantized:
        k_rolled = k_rolled * ks[..., None]
        v_rolled = v_rolled * vs[..., None]
    L = k_rolled.shape[0]
    # rotating a post-rope K from position p to p - nd is the rotation at -nd
    cos, sin = rope_cache(cfg, torch.full((1, 1), -n_discard, dtype=torch.float32,
                                          device=dev))
    half = cos.shape[-1]
    k_shifted = apply_rope(k_rolled.to(torch.bfloat16), cos.expand(L, S, half),
                           sin.expand(L, S, half), cfg.rope_type, cfg.rope_dim)
    # the rows each bank rotates: the moved ones, on the roped layers' banks
    # (a shared-KV cache has banks for its first kv_owners layers alone)
    roped = torch.tensor([not f for f in nope_flags(cfg)][:L], device=dev)
    mv = moved[None, :, None, None] & roped[:, None, None, None]

    def put(buf, val):  # seq-major (L, S, Hkv[, D]) -> the slot's head-major rows
        buf[:, slot] = val.transpose(1, 2).to(buf.dtype)

    if cache.quantized:
        k_new = torch.where(mv, k_shifted.to(torch.float32), k_rolled)
        (kq, ksc), (vq, vsc) = _kv_quant(k_new), _kv_quant(v_rolled)
        for buf, val in ((cache.k, kq), (cache.v, vq), (cache.ks, ksc), (cache.vs, vsc)):
            put(buf, val)
        return
    k_new = torch.where(mv, k_shifted.to(cache.k.dtype), k_rolled)
    put(cache.k, k_new)
    put(cache.v, v_rolled)


def _mla_shift(cache: KVCache, cfg: ModelConfig, slot: int, src, moved, n_discard: int):
    """The shift of an MLA cache, whose K row is [c_kv (kv_lora); k_pe
    (rope_dim)] and V row c_kv: every row of the slot moves to its place by
    ``src``; of the moved rows only the k_pe tail is rotated, by the pure
    rotation at -n_discard (in f32; the magnitude YaRN's mscale gave k_pe
    at its write stays once, as the rotation's cos and sin carry no mscale).
    V, its row scales and the c_kv part of K move bit for bit; on the int8
    cache a moved K row is requantized after its rotation and the others
    keep their bits. This is llama.cpp's shift (it views the rope part of
    the row). The JAX package's shift rotates the first rope_dim dims of
    each K row (memory.py:301-311), which in this layout are c_kv's, and
    leaves k_pe unrotated: a departure from the reference (ROADMAP §3)."""
    lora, rd = cfg.kv_lora_rank, cfg.rope_dim
    for buf in (cache.v, cache.vs):  # head-major (L, B, 1, S[, D]): the slot's rows by src
        if buf is not None:
            buf[:, slot] = buf[:, slot][:, :, src]
    k = cache.k[:, slot][:, :, src]  # (L, 1, S, Dk)
    kf = k.to(torch.float32)
    if cache.quantized:
        ks = cache.ks[:, slot][:, :, src]
        kf = kf * ks[..., None]
    L, S = k.shape[0], k.shape[2]
    theta, _ = rope_angles(cfg, torch.full((1, 1), -n_discard, dtype=torch.float32,
                                           device=k.device))
    half = theta.shape[-1]
    cos, sin = (f(theta).expand(L, S, half) for f in (torch.cos, torch.sin))
    tail = kf[..., lora:].transpose(1, 2)  # (L, S, 1, rope_dim): rows as tokens
    rot = apply_rope(tail, cos, sin, cfg.rope_type, rd).transpose(1, 2)
    mv = moved[None, None, :, None]
    if cache.quantized:
        kq, ksc = _kv_quant(torch.cat([kf[..., :lora], rot], dim=-1))
        cache.k[:, slot] = torch.where(mv, kq, k)
        cache.ks[:, slot] = torch.where(mv[..., 0], ksc, ks)
        return
    cache.k[:, slot] = torch.cat(
        [k[..., :lora], torch.where(mv, rot.to(k.dtype), k[..., lora:])], dim=-1)
