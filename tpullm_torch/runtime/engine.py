"""Inference engine: bucketed prefill + chunked decode.

Counterpart of tpullm/runtime/engine.py. Prompts are left-padded to a
power-of-two bucket; one prefill writes the cache, then decode runs in
chunks of ``decode_chunk`` steps. Each step is a forward over one token per
row, an on-device sample and the advance of the carried state; the host
reads the chunk's tokens once, at its end.

The JAX engine runs a chunk as one jitted ``lax.scan``, compiled per
(sampler, chunk, eos, kv_view) (engine.py:112-158). Here, on the card, each
step is one replay of a CUDA graph of ``_step``, captured once per
``step_key`` (batch size, sampler, kv view, attention route) and replayed
``chunk`` times a chunk, so chunks of any length share it. A graph keeps
every pointer it saw, so the engine owns the step's buffers (``DecodeState``:
the KV cache, the carried token, position and slot, the chunk's tokens) for
each batch size and reuses them across ``generate`` calls; slots an earlier
call left in the cache are masked as the JAX engine's donated cache is (by
``valid_from`` and the query slots). Prefill stays eager: its bucketed
shapes vary. The first step of a new key runs eagerly on a side stream (the
warm-up: every kernel's first use, and its counters, before capture), then
the step is captured there; eager steps and replays run on the caller's
stream, fenced from the side stream, so no two launches of kernel D or E
on the engine's arrival counters overlap; those counters are the engine's
own (``DecodeState.counters``, ``_cuda.counters_scope``), so a server or
another engine in another thread never shares them. There is no fallback:
a failed capture raises. ``cuda_graphs=False`` runs the same step eagerly
on the card, to hold the graph against; on the CPU the step always runs
eagerly.

The JAX chunk skips the layer stack once every row has sampled EOS
(``lax.cond``); here the chunk runs to its end and the host trims the
tokens after EOS, so the output is the same.

``iswa`` gives a model with SWA layers the dual cache (a ring of window +
``prefill_chunk`` slots on its SWA layers; not on the int8 cache), as the
JAX engine does (engine.py:53-66); its prefill then runs in pieces of at
most ``prefill_chunk`` rows, so no forward writes more rows than the ring
holds beyond the window.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.llama import (KVCache, check_positions, decode_route, forward, has_sinks,
                            params_device, swa_flags)
from ..ops import _cuda
from ..ops._cuda import resolve_device
from ..ops.sampling import GREEDY, SamplerConfig, make_sample_fn


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def kv_view_bucket(slot: int, chunk: int, max_seq_len: int) -> int:
    """Attention reads cache slots [0, view): a power of two >= 512 covering
    the furthest slot the chunk writes (engine.py:242-249)."""
    need = slot + chunk
    view = 512
    while view < need:
        view *= 2
    return min(view, max_seq_len)


def decode_chunks(T: int, max_new_tokens: int, max_seq_len: int, decode_chunk: int):
    """-> [(slot, chunk, kv_view)] of the decode chunks after a prefill of T
    slots (engine.py:228-249): full chunks, then power-of-two chunks that
    fill the cache's last slots. ``max_new_tokens`` counts the prefill's
    token."""
    out = []
    produced, slot = 1, T
    while produced < max_new_tokens and slot < max_seq_len:
        room = max_seq_len - slot
        chunk = decode_chunk if room >= decode_chunk else 1 << (room.bit_length() - 1)
        out.append((slot, chunk, kv_view_bucket(slot, chunk, max_seq_len)))
        produced += chunk
        slot += chunk
    return out


def step_key(cfg: ModelConfig, B: int, sampler: SamplerConfig, kv_view: int, kv_dtype,
             on_card: bool, ring: int = 0, sinks: bool = False) -> tuple:
    """What a captured decode step depends on beyond its buffers: the batch
    size, the sampler, the kv view and the attention routes that forward
    takes there (models/llama.py:decode_route, which reads
    TPULLM_FLASH_DECODE; a dual cache's ring layers have their own; a model
    with attention sinks keeps its ring steps off kernel C). The JAX key
    (sampler, chunk, eos, kv_view) less chunk and eos, as one step is
    captured, not a chunk."""
    return (B, sampler, kv_view, decode_route(cfg, B, kv_view, kv_dtype, on_card, ring, sinks))


@dataclass
class GenerationResult:
    tokens: list[list[int]]
    logits: np.ndarray | None = None  # (B, vocab) logits after the prompt
    n_prefill: int = 0
    n_decode: int = 0


@dataclass
class DecodeState:
    """The decode step's buffers for one batch size B. A captured step
    reads and writes these in place, so they live as long as the engine."""

    cache: KVCache
    tok: torch.Tensor  # (B,) int64: the last sampled token of each row
    pos: torch.Tensor  # (B,) int64: its position
    slot: torch.Tensor  # (B,) int64: the cache slot it is written to (every row the same)
    valid_from: torch.Tensor  # (B,) int64: each row's first valid slot
    toks: torch.Tensor  # (decode_chunk, B) int32: the chunk's tokens
    step: torch.Tensor  # (1,) int64: the row of toks the next step writes
    counters: dict  # kernel D's and E's arrival counters (_cuda.own_counters)


class InferenceEngine(_cuda.GraphOwner):
    """Single-model batch inference with on-device sampling."""

    def __init__(self, cfg: ModelConfig, params: dict, max_seq_len: int = 1024,
                 compute_dtype=torch.bfloat16, kv_dtype=None, decode_chunk: int = 32,
                 iswa: bool = False, prefill_chunk: int = 128, device="cuda",
                 cuda_graphs: bool = True):
        self.device = resolve_device(device)
        pdev = params_device(params)
        if pdev.type != self.device.type:
            raise ValueError(f"params are on {pdev}, engine device is {self.device}")
        check_positions(params, max_seq_len, "InferenceEngine: max_seq_len")
        self.cfg = cfg
        self.params = params
        self.max_seq_len = max_seq_len
        self.dtype = compute_dtype
        self.kv_dtype = kv_dtype or compute_dtype
        self.decode_chunk = decode_chunk
        # the JAX engine's gate (engine.py:64-66): the dual cache only where
        # there are SWA layers, and never on the int8 cache
        self.iswa = bool(iswa and any(swa_flags(cfg)) and self.kv_dtype not in ("q8", "int8"))
        self.prefill_chunk = prefill_chunk
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda"
        self.gen = torch.Generator(device=self.device)  # every draw, eager or replayed
        self.states: dict[int, DecodeState] = {}  # by batch size
        self._init_graphs()  # by step_key

    def new_cache(self, batch: int) -> KVCache:
        return KVCache.create(self.cfg, batch, self.max_seq_len, self.kv_dtype, self.device,
                              iswa=self.iswa, max_chunk=self.prefill_chunk)

    def decode_state(self, B: int) -> DecodeState:
        """The engine's decode buffers for batch size B, made at first use
        (before any capture), with kernel D's and E's arrival counters sized
        for B rows and max_seq_len."""
        st = self.states.get(B)
        if st is None:
            z = lambda *shape: torch.zeros(shape, dtype=torch.int64, device=self.device)
            cache = self.new_cache(B)
            st = DecodeState(cache, z(B), z(B), z(B), z(B),
                             torch.zeros((self.decode_chunk, B), dtype=torch.int32,
                                         device=self.device), z(1),
                             _cuda.own_counters(self.device, B, self.cfg.n_head_kv,
                                                self.max_seq_len, cache.ring))
            self.states[B] = st
        return st

    def prepare_batch(self, prompts: list[list[int]]):
        """Left-pad to a power-of-two bucket; returns device inputs."""
        B = len(prompts)
        lens = np.array([len(p) for p in prompts], np.int32)
        T = _bucket(int(lens.max()))
        tokens = np.zeros((B, T), np.int64)
        positions = np.zeros((B, T), np.int64)
        for i, p in enumerate(prompts):
            pad = T - len(p)
            tokens[i, pad:] = p
            positions[i, pad:] = np.arange(len(p))
        valid_from = (T - lens).astype(np.int64)
        to = lambda a: torch.from_numpy(a).to(self.device)
        return to(tokens), to(positions), to(valid_from), T, lens

    def _prefill(self, tokens, positions, cache, valid_from):
        """The prompt's forward -> (last row's logits, cache); on a dual cache
        in pieces of at most prefill_chunk rows (engine.py:199-206)."""
        T = tokens.shape[1]
        C = self.prefill_chunk if cache.dual and T > self.prefill_chunk else T
        for o in range(0, T, C):
            logits, cache = forward(self.params, self.cfg, tokens[:, o:o + C],
                                    positions[:, o:o + C], cache, o, valid_from, self.dtype)
        return logits[:, -1, :], cache

    def _step(self, st: DecodeState, sample, kv_view: int) -> None:
        """One decode step on the state's buffers, all on the device: the
        function a graph captures. Every row writes the cache at st.slot."""
        logits, _ = forward(self.params, self.cfg, st.tok[:, None], st.pos[:, None], st.cache,
                            st.slot, st.valid_from, self.dtype, kv_view_len=kv_view)
        nxt = sample(logits[:, -1, :], self.gen)
        st.toks.index_copy_(0, st.step, nxt[None])
        st.tok.copy_(nxt)
        st.pos.add_(1)
        st.slot.add_(1)
        st.step.add_(1)

    def decode_step(self, st: DecodeState, sampler: SamplerConfig, kv_view: int) -> None:
        """One decode step: a replay of the key's graph; for a new key, one
        eager step as the warm-up and the capture; eager without graphs."""
        if not self.cuda_graphs:
            with _cuda.counters_scope(st.counters):
                self._step(st, make_sample_fn(sampler), kv_view)
            return
        key = step_key(self.cfg, st.tok.shape[0], sampler, kv_view, st.cache.k.dtype, True,
                       st.cache.ring, has_sinks(self.params))
        graph = self.graphs.get(key)
        if graph is None:
            with _cuda.counters_scope(st.counters):
                self._warm_up_and_capture(key, st, sampler, kv_view)
        else:
            graph.replay()

    def _warm_up_and_capture(self, key, st, sampler, kv_view) -> None:
        """Run the step eagerly on the side stream (a real step: its tokens
        count), then capture it there as the key's graph."""
        sample = make_sample_fn(sampler)
        self._capture(key, lambda: self._step(st, sample, kv_view), (self.gen,))

    @torch.inference_mode()
    def generate(self, prompts: list[list[int]], max_new_tokens: int = 32,
                 sampler: SamplerConfig | None = None, seed: int = 0,
                 eos_id: int | None = None, return_logits: bool = False) -> GenerationResult:
        sampler = sampler or GREEDY
        sample = make_sample_fn(sampler)
        self.gen.manual_seed(seed)
        tokens, positions, valid_from, T, lens = self.prepare_batch(prompts)
        B = tokens.shape[0]
        if T >= self.max_seq_len:
            raise ValueError(f"prompt bucket {T} >= max_seq_len {self.max_seq_len}")
        max_new_tokens = min(max_new_tokens, self.max_seq_len - T + 1)
        st = self.decode_state(B)
        with _cuda.counters_scope(st.counters):
            logits, _ = self._prefill(tokens, positions, st.cache, valid_from)
        first_logits = logits.cpu().numpy() if return_logits else None
        tok = sample(logits, self.gen)
        st.tok.copy_(tok)
        st.pos.copy_(torch.from_numpy(lens.astype(np.int64)))
        st.valid_from.copy_(valid_from)

        out_chunks = [tok.cpu().numpy()[None]]  # (1, B)
        for slot, chunk, kv_view in decode_chunks(T, max_new_tokens, self.max_seq_len,
                                                  self.decode_chunk):
            if slot + chunk > self.max_seq_len:  # decode_chunks keeps to the cache
                raise RuntimeError(f"chunk of {chunk} at slot {slot} past {self.max_seq_len}")
            st.slot.fill_(slot)
            st.step.zero_()
            for _ in range(chunk):
                self.decode_step(st, sampler, kv_view)
            # (chunk, B): one host read, copied (on the CPU .numpy() shares st.toks)
            out_chunks.append(st.toks[:chunk].cpu().numpy().copy())
            if eos_id is not None:
                flat = np.concatenate(out_chunks, axis=0)
                if all((flat[:, b] == eos_id).any() for b in range(B)):
                    break

        flat = np.concatenate(out_chunks, axis=0)  # (N, B)
        out: list[list[int]] = []
        for b in range(B):
            seq = flat[:, b].tolist()
            if eos_id is not None and eos_id in seq:
                seq = seq[: seq.index(eos_id) + 1]
            out.append(seq[:max_new_tokens])
        return GenerationResult(tokens=out, logits=first_logits,
                                n_prefill=int(lens.sum()),
                                n_decode=sum(len(o) for o in out))

    @torch.inference_mode()
    def logits_for(self, prompts: list[list[int]]) -> np.ndarray:
        """Logits after the prompt's last token (testing/perplexity)."""
        tokens, positions, valid_from, T, lens = self.prepare_batch(prompts)
        logits, _ = self._prefill(tokens, positions, self.new_cache(tokens.shape[0]), valid_from)
        return logits.cpu().numpy()
