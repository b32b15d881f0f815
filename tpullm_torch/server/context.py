"""Serving engine: slots, task queue, continuous batching loop.

Counterpart of tpullm/server/context.py for the attention family:

- A slot is a fixed batch row of the preallocated KV cache (SlotMemory);
  admitting a task is a host-side free-slot pop plus a prefix-cache match.
- Prompt processing runs one bucketed prefill chunk per loop iteration per
  pending slot, written into that slot's cache row (``forward(slot0=i)``).
- Decode runs ``decode_chunk`` steps for all slots at once, each row at its
  own depth (a per-row ``cache_pos``), with per-row sampler parameters
  (``sample_batch``). The JAX package runs the chunk as one jitted
  ``lax.scan`` (context.py:267-310); here, on the card, each step is one
  replay of a CUDA graph of ``_step``, captured once per ``step_key``
  (slots, kv view, logprobs or not, attention route) and replayed
  ``decode_chunk`` times a chunk; the host reads the chunk's tokens (and
  top-8 logprobs, when a request asks for them) once, at its end. A graph
  keeps every pointer it saw, so every tensor the step reads or writes is
  made once and updated in place (``ServerDecodeState``, the sampler rows,
  the penalty ring, the logit bias, the cache); admissions write them
  between chunks, and the draw generator is registered with each graph, so
  a reseed reaches the replays. The first step of a new key runs eagerly on
  a side stream, then is captured there (``_cuda.GraphOwner._capture``);
  kernels D and E launch on the server's own arrival counters.
  ``cuda_graphs=False`` runs the same step eagerly; on the CPU it always
  runs eagerly. Prefill stays eager: its chunk lengths vary.
- Stops (EOS, stop strings, limits) are handled on the host between chunks;
  the bounded overrun tokens are discarded (cache rows past n_past are
  masked by position).
- ``iswa`` gives a model with SWA layers the dual cache (a ring of window +
  ``prefill_chunk`` slots on its SWA layers; not on the int8 cache), as the
  JAX server does: a slot that would overflow is then reprocessed from its
  kept tokens rather than shifted (context.py:877-896), and a prefix is
  reused only while the ring still holds its window.

Not ported, and refused rather than ignored: LoRA adapters, multimodal
projectors, speculative decoding, slot save/restore, the recurrent, hybrid
and encoder-decoder families, grammar, JSON-schema and infill-sampler
requests, and embeddings.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.llama import (MOE_KEYS, check_dense, check_positions, decode_route, forward,
                            has_sinks, params_device)
from ..ops import _cuda
from ..ops._cuda import resolve_device
from ..ops.sampling import BatchSamplerParams, PenaltyState, SamplerConfig, sample_batch
from ..runtime.memory import SlotMemory

log = logging.getLogger("tpullm_torch.server")


@dataclass
class GenParams:
    max_tokens: int = 128
    n_keep: int = 0  # tokens kept at context shift (0 = prompt-derived)
    temperature: float = 1.0
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    typical_p: float = 1.0
    top_n_sigma: float = 0.0
    xtc_probability: float = 0.0
    xtc_threshold: float = 0.1
    penalty_repeat: float = 1.0
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    mirostat: int = 0  # 0 = off, 1 = mirostat v1, 2 = mirostat v2
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    dry_multiplier: float = 0.0
    dry_base: float = 1.75
    dry_allowed_length: int = 2
    seed: int = -1  # -1 -> time-based
    stop: list[str] = field(default_factory=list)
    ignore_eos: bool = False
    stream: bool = False
    n_probs: int = 0
    grammar: str | None = None  # not ported: the request is refused
    json_schema: dict | None = None  # not ported: the request is refused
    grammar_lazy: bool = False
    grammar_triggers: tuple = ()
    # {token_id: bias} (OpenAI dict) or [[token_id, bias|false], ...]
    # (llama.cpp list form); false -> token banned
    logit_bias: dict | list | None = None
    infill_sampler: bool = False  # not ported: the request is refused

    def sampler_config(self) -> SamplerConfig:
        if self.top_k > 256:
            # the sampler runs its truncation chain on the top-256 candidates
            log.warning("top_k=%d exceeds the candidate window (256); clamping to 256",
                        self.top_k)
        return SamplerConfig(
            temperature=self.temperature, top_k=self.top_k, top_p=self.top_p,
            min_p=self.min_p, typical_p=self.typical_p, top_n_sigma=self.top_n_sigma,
            xtc_probability=self.xtc_probability, xtc_threshold=self.xtc_threshold,
            penalty_repeat=self.penalty_repeat, penalty_freq=self.penalty_freq,
            penalty_present=self.penalty_present,
            mirostat_tau=self.mirostat_tau if self.mirostat in (1, 2) else 0.0,
            mirostat_eta=self.mirostat_eta, mirostat_v=self.mirostat or 2,
            dry_multiplier=self.dry_multiplier, dry_base=self.dry_base,
            dry_allowed=self.dry_allowed_length, greedy=self.temperature <= 0)

    def unported(self) -> str | None:
        """The request features this server refuses, named, or None."""
        names = [n for n, on in (("grammar", self.grammar or self.grammar_lazy
                                  or self.grammar_triggers),
                                 ("json_schema", self.json_schema is not None),
                                 ("infill sampler", self.infill_sampler)) if on]
        return ", ".join(names) or None


@dataclass
class Task:
    tokens: list  # prompt token ids
    params: GenParams
    id: str = field(default_factory=lambda: f"task-{uuid.uuid4().hex[:12]}")
    out: queue.Queue = field(default_factory=queue.Queue)
    cancelled: threading.Event = field(default_factory=threading.Event)
    submitted_at: float = field(default_factory=time.time)

    def events(self):
        """Iterate ('delta'|'done'|'error', payload) until completion."""
        while True:
            kind, payload = self.out.get()
            yield kind, payload
            if kind in ("done", "error"):
                return


@dataclass
class _SlotRt:
    """Per-slot runtime state of the loop."""
    task: Task | None = None
    pending: list = field(default_factory=list)  # prompt tokens not yet prefilled
    gen: list = field(default_factory=list)  # generated token ids
    gen_probs: list = field(default_factory=list)  # per-token logprob entries
    sent_text: str = ""
    n_prompt: int = 0
    reused: int = 0
    started_at: float = 0.0
    prefill_done_at: float = 0.0


@dataclass
class ServerDecodeState:
    """The decode step's buffers, made once per server. A captured step reads
    and writes these in place, so none is ever rebound."""

    logits: torch.Tensor  # (B, V) f32: the carried next-token logits
    ctl: torch.Tensor  # (2B + 1,) int64: pos, active and step, one host copy a chunk
    pos: torch.Tensor  # (B,) view of ctl: each row's next position
    active: torch.Tensor  # (B,) view of ctl, 0 or 1: the rows that advance
    step: torch.Tensor  # (1,) view of ctl: the row of the chunk's outputs the step writes
    valid_from: torch.Tensor  # (B,) int64 zeros
    mu: torch.Tensor  # (B,) f32: mirostat's carried target surprise
    toks: torch.Tensor  # (decode_chunk, B) int32: the chunk's tokens
    tok_lp: torch.Tensor  # (decode_chunk, B) f32: each token's logprob
    top_v: torch.Tensor  # (decode_chunk, B, 8) f32: the top-8 logprobs
    top_i: torch.Tensor  # (decode_chunk, B, 8) int64: and their ids

    @staticmethod
    def create(B: int, V: int, chunk: int, device) -> "ServerDecodeState":
        f32 = dict(dtype=torch.float32, device=device)
        ctl = torch.zeros((2 * B + 1,), dtype=torch.int64, device=device)
        return ServerDecodeState(
            torch.zeros((B, V), **f32), ctl, ctl[:B], ctl[B: 2 * B], ctl[2 * B:],
            torch.zeros((B,), dtype=torch.int64, device=device), torch.zeros((B,), **f32),
            torch.zeros((chunk, B), dtype=torch.int32, device=device),
            torch.zeros((chunk, B), **f32), torch.zeros((chunk, B, 8), **f32),
            torch.zeros((chunk, B, 8), dtype=torch.int64, device=device))


def step_key(cfg: ModelConfig, n_slots: int, kv_view: int, want_probs: bool, kv_dtype,
             on_card: bool, ring: int = 0, sinks: bool = False) -> tuple:
    """What a captured server decode step depends on beyond its buffers: the
    slots, the kv view, whether it writes logprobs, and the attention routes
    forward takes there (models/llama.py:decode_route, which reads
    TPULLM_FLASH_DECODE at each call; a dual cache's ring layers have their
    own; a model with attention sinks keeps its ring steps off kernel C).
    The per-row sampler parameters are tensors, so admissions never need a
    new graph."""
    return (n_slots, kv_view, want_probs,
            decode_route(cfg, n_slots, kv_view, kv_dtype, on_card, ring, sinks))


def _bucket(n: int, minimum: int = 32) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def prefill_chunk(params: dict, cfg: ModelConfig, cache, slot: int, n_past: int,
                  chunk: list, dtype):
    """One prompt chunk of a slot through the server layout: padded to its
    bucket, written at the slot's cache row from n_past on (``slot0``),
    logits for its last real token only. -> (1, 1, vocab) f32.

    On the dual cache the bucket is cut to the ring's room, ring - window
    rows (never below the chunk): a padding row's write lands at its
    position modulo the ring, so more rows than that would overwrite ring
    slots that the chunk's own queries still see (forward: T <= ring -
    window). The JAX ServerContext pads to at least 32 rows on any ring
    (server/context.py), which gives wrong tokens on a ring of fewer than
    window + 32 slots."""
    Tc = len(chunk)
    Tb = _bucket(Tc)
    if cache.dual:
        Tb = max(Tc, min(Tb, cache.ring - cfg.sliding_window))
    toks = np.zeros((1, Tb), np.int64)
    toks[0, :Tc] = chunk
    pos = n_past + np.arange(Tb, dtype=np.int64)[None]
    dev = cache.k.device
    logits, _ = forward(params, cfg, torch.from_numpy(toks).to(dev),
                        torch.from_numpy(pos).to(dev), cache, n_past,
                        torch.zeros((1,), dtype=torch.int64, device=dev), dtype,
                        slot0=slot, logits_idx=Tc - 1)
    return logits


def _refuse_unported(cfg: ModelConfig, params: dict, **opts) -> None:
    """Raise on every construction option and model family not ported."""
    for name, val in opts.items():
        if val:
            raise NotImplementedError(f"ServerContext {name}={val!r}: not ported to "
                                      "tpullm_torch yet")
    family = ("t5" if cfg.arch in ("t5", "t5encoder") else "rwkv" if cfg.wkv_head_size
              else "hybrid" if cfg.hybrid_graph or cfg.ssm_d_conv else None)
    if family:
        raise NotImplementedError(f"the {family} family's serving path is not ported "
                                  "to tpullm_torch yet")
    layers = params["layers"].get("__groups__") or [params["layers"]]
    check_dense(cfg, moe=any(MOE_KEYS & set(gl) for gl in layers))


class ServerContext(_cuda.GraphOwner):
    def __init__(self, cfg: ModelConfig, params: dict, tokenizer=None, n_slots: int = 4,
                 max_seq_len: int = 2048, decode_chunk: int = 8, prefill_chunk: int = 512,
                 compute_dtype=torch.bfloat16, kv_dtype=None, model_name: str = "tpullm",
                 slot_save_path: str | None = None, mmproj_path: str | None = None,
                 iswa: bool = False, spec: str | None = None, draft: tuple | None = None,
                 lora: list | None = None, device="cuda", cuda_graphs: bool = True):
        """The JAX ServerContext's signature; every option not ported raises.
        kv_dtype "q8" selects the int8 cache; iswa the dual cache where the
        model has SWA layers and the cache is not int8 (its ring holds
        window + prefill_chunk slots). Runs on the card unless device="cpu";
        there each decode step is a CUDA graph replay unless
        cuda_graphs=False."""
        self.device = resolve_device(device)
        pdev = params_device(params)
        if pdev.type != self.device.type:
            raise ValueError(f"params are on {pdev}, the server's device is {self.device}")
        _refuse_unported(cfg, params, lora=lora, mmproj_path=mmproj_path, spec=spec,
                         draft=draft, slot_save_path=slot_save_path)
        # a slot's real positions stay below its context (a context shift lowers them)
        check_positions(params, max_seq_len, "ServerContext: max_seq_len")
        self.tok = tokenizer  # None: token-id prompts, the text is the ids
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_seq_len = max_seq_len
        self.decode_chunk = decode_chunk
        self.prefill_chunk = prefill_chunk
        self.dtype = compute_dtype
        self.model_name = model_name
        self.memory = SlotMemory(cfg, n_slots, max_seq_len, kv_dtype or compute_dtype,
                                 self.device, iswa=iswa, max_chunk=prefill_chunk)
        self.rt = [_SlotRt() for _ in range(n_slots)]
        self.queue: "queue.Queue[Task]" = queue.Queue()
        # closures run on the loop thread between decode chunks
        self._ctrl: "queue.Queue" = queue.Queue()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._wake = threading.Event()

        dev = self.device
        V = cfg.vocab_size
        self.sparams = BatchSamplerParams.neutral(n_slots, dev)
        self.penalties = PenaltyState.create(n_slots, V, device=dev)
        self._pos = np.zeros(n_slots, np.int64)
        self._active = np.zeros(n_slots, bool)
        self._gen = torch.Generator(device=dev)
        self._seed = 0
        self._gen.manual_seed(self._seed)
        self._bias = torch.zeros((n_slots, V), dtype=torch.float32, device=dev)
        self._bias_set = np.zeros(n_slots, bool)
        self.state = ServerDecodeState.create(n_slots, V, decode_chunk, dev)
        self.counters = _cuda.own_counters(dev, n_slots, cfg.n_head_kv, max_seq_len,
                                           self.memory.cache.ring)
        self.cuda_graphs = cuda_graphs and dev.type == "cuda"
        self._init_graphs()  # by step_key
        self.metrics = {
            "requests_total": 0, "prompt_tokens_total": 0,
            "generated_tokens_total": 0, "prefill_seconds_total": 0.0,
            "decode_seconds_total": 0.0, "queue_depth": 0, "slots_busy": 0,
        }

    # ------------------------------------------------------------------ api

    def submit(self, task: Task) -> Task:
        self.metrics["requests_total"] += 1
        self.queue.put(task)
        self._wake.set()
        return task

    def control(self, fn, timeout: float = 60.0):
        """Run fn() on the loop thread, serialized with decode (inline when
        the loop is not running). Returns its result or re-raises."""
        if self._thread is None or not self._thread.is_alive():
            return fn()
        done: "queue.Queue" = queue.Queue()
        self._ctrl.put((fn, done))
        self._wake.set()
        kind, val = done.get(timeout=timeout)
        if kind == "error":
            raise val
        return val

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=30)

    # ----------------------------------------------------------------- loop

    def _free_slots(self):
        return [i for i, r in enumerate(self.rt) if r.task is None]

    def _admit(self):
        for i in self._free_slots():
            try:
                task = self.queue.get_nowait()
            except queue.Empty:
                break
            if task.cancelled.is_set():
                continue
            toks = list(task.tokens)
            if len(toks) >= self.max_seq_len - 1:
                task.out.put(("error", f"prompt too long ({len(toks)} tokens)"))
                continue
            refused = task.params.unported()
            if refused:
                task.out.put(("error", f"{refused}: not ported to tpullm_torch yet"))
                continue
            r = self.rt[i]
            r.task = task
            r.gen = []
            r.gen_probs = []
            r.sent_text = ""
            r.n_prompt = len(toks)
            r.started_at = time.time()
            reuse = self.memory.prefix_match(i, toks)
            r.reused = reuse
            self.memory.truncate(i, reuse)
            r.pending = toks[reuse:]
            self.memory.slots[i].tokens = toks[:reuse]
            # a parked row's decode-step scratch write lands at its own
            # n_past, so _pos must never lag behind the cache content
            self._pos[i] = reuse
            self.sparams.set_row_(i, task.params.sampler_config())
            row = self._bias_row(task.params.logit_bias)
            if row is not None:
                self._bias[i] = torch.from_numpy(row).to(self.device)
                self._bias_set[i] = True
            elif self._bias_set[i]:  # clear a stale bias of a prior task
                self._bias[i] = 0
                self._bias_set[i] = False
            self.penalties.clear_row(i)
            seed = task.params.seed if task.params.seed >= 0 else time.time_ns() % (2 ** 31)
            # fold the request's seed into the shared draw stream
            self._seed = (self._seed * 1_000_003 + int(seed) + 1) % (2 ** 63)
            self._gen.manual_seed(self._seed)
            self.state.mu[i] = 2.0 * task.params.mirostat_tau

    def _prefill_step(self, i: int):
        """One bucketed prompt chunk for slot i; on the last chunk keep the
        next-token logits for the decode loop."""
        r = self.rt[i]
        st = self.memory.slots[i]
        chunk = r.pending[: self.prefill_chunk]
        is_last = len(chunk) == len(r.pending)
        Tc = len(chunk)
        t0 = time.time()
        with _cuda.counters_scope(self.counters):
            logits = prefill_chunk(self.params, self.cfg, self.memory.cache, i, st.n_past,
                                   chunk, self.dtype)
        self.metrics["prefill_seconds_total"] += time.time() - t0
        self.metrics["prompt_tokens_total"] += Tc
        st.tokens.extend(chunk)
        st.n_past += Tc
        self._pos[i] = st.n_past
        r.pending = r.pending[Tc:]
        if is_last:
            self.state.logits[i] = logits[0, 0]
            self._active[i] = True
            r.prefill_done_at = time.time()

    def _finish(self, i: int, reason: str):
        r = self.rt[i]
        task = r.task
        self._active[i] = False
        if task is not None:
            now = time.time()
            stats = {
                "prompt_tokens": r.n_prompt,
                "completion_tokens": len(r.gen),
                "cached_tokens": r.reused,
                "prefill_s": round(max(r.prefill_done_at - r.started_at, 0), 4),
                "decode_s": round(max(now - (r.prefill_done_at or now), 0), 4),
            }
            done = {"reason": reason, "stats": stats, "text": r.sent_text,
                    "tokens": list(r.gen)}
            if r.gen_probs:
                done["logprobs"] = list(r.gen_probs)
            task.out.put(("done", done))
        r.task = None
        r.pending = []

    def _emit(self, i: int, new_tokens: list[int], probs=None):
        """Append tokens, check stops, stream the text delta. With a
        tokenizer: stop at an end-of-generation token (unless ignore_eos),
        re-decode the whole completion without special tokens and hold back
        a trailing partial UTF-8 character. Without one the text is the
        token ids joined by spaces."""
        r = self.rt[i]
        task = r.task
        p = task.params
        vocab = self.tok.vocab if self.tok else None
        finished = None
        for step, t in enumerate(new_tokens):
            t = int(t)
            if not p.ignore_eos and vocab is not None and vocab.is_eog(t):
                finished = "stop"
                break
            r.gen.append(t)
            if probs is not None and step < len(probs):
                r.gen_probs.append({"token": t, **probs[step]})
            self.memory.slots[i].tokens.append(t)
            if len(r.gen) >= p.max_tokens:
                finished = "length"
                break
        if self.tok is not None:
            text = self.tok.decode(r.gen, skip_special=True)
            if text.endswith("\ufffd"):  # hold back partial utf-8
                text = text[: text.rfind("\ufffd")]
        else:
            text = " ".join(map(str, r.gen))
        for s in p.stop:
            idx = text.find(s, max(0, len(r.sent_text) - len(s)))
            if idx >= 0:
                text = text[:idx]
                finished = "stop"
                break
        delta = text[len(r.sent_text):]
        if delta and p.stream:
            task.out.put(("delta", {"text": delta, "tokens": new_tokens}))
        r.sent_text = text
        if task.cancelled.is_set():
            finished = "cancelled"
        if finished:
            st = self.memory.slots[i]
            st.n_past = r.n_prompt + len(r.gen)
            st.tokens = st.tokens[: r.n_prompt + len(r.gen)]
            self._finish(i, finished)

    def _bias_row(self, lb) -> "np.ndarray | None":
        """logit_bias -> a dense (V,) f32 row (None if absent): the OpenAI
        dict {token_id: bias} or the llama.cpp list [[token_id, bias|false]];
        false bans the token."""
        if not lb:
            return None
        row = np.zeros(self.cfg.vocab_size, np.float32)
        items = lb.items() if isinstance(lb, dict) else \
            ((e[0], e[1]) for e in lb if isinstance(e, (list, tuple)) and len(e) == 2)
        for tok, b in items:
            t = int(tok)
            if 0 <= t < self.cfg.vocab_size:
                row[t] = np.float32(-1e9) if b is False else np.float32(b)
        return row

    def _context_shift_overdue(self, n_steps: int):
        """Shift slots that would overflow the cache this chunk; on a dual
        cache, whose ring cannot shift, reprocess the kept tokens through
        the prompt path instead (context.py:877-896)."""
        S = self.max_seq_len
        for i in range(self.n_slots):
            if not self._active[i] or self._pos[i] + n_steps + 1 < S:
                continue
            r = self.rt[i]
            st = self.memory.slots[i]
            keep = r.task.params.n_keep or min(r.n_prompt, S // 4)
            nd = max((st.n_past - keep) // 2, n_steps + 1)
            if self.memory.cache.dual:
                kept = st.tokens[:keep] + st.tokens[keep + nd:]
                self.memory.clear_slot(i)
                self._active[i] = False
                self._pos[i] = 0
                r.pending = kept
            else:
                self.memory.context_shift(i, keep, nd)
                self._pos[i] = st.n_past
            self.metrics["context_shifts_total"] = (
                self.metrics.get("context_shifts_total", 0) + 1)

    def _kv_view_bucket(self, n_steps: int) -> int:
        """Power-of-two attention view (>= 512) covering every active slot's
        furthest write this chunk. It bounds the full banks only: forward
        reads a ring bank whole."""
        pos = [int(self._pos[i]) for i in range(self.n_slots) if self._active[i]]
        need = (max(pos) if pos else 0) + n_steps + 1
        v = 512
        while v < need:
            v *= 2
        return min(v, self.max_seq_len)

    def _step(self, kv_view: int, want_probs: bool) -> None:
        """One sample-then-forward step on the state's buffers, all on the
        device: the function a graph captures. It samples from the carried
        logits (first step: the prefill's), writes the sampled token's K/V at
        its row's position and carries the next logits. Parked rows write at
        their own n_past, which the next prompt chunk or token of that slot
        overwrites."""
        st, pen = self.state, self.penalties
        nxt, mu = sample_batch(st.logits, self.sparams, self._gen, pen.counts, st.mu,
                               dry_ctx=pen.ordered(), bias=self._bias)
        st.mu.copy_(mu)
        pen.push(nxt)
        if want_probs:
            lp = torch.log_softmax(st.logits, dim=-1)
            topv, topi = torch.topk(lp, 8, dim=-1)
            tok_lp = torch.gather(lp, -1, nxt[:, None].to(torch.int64))[:, 0]
            for buf, val in ((st.tok_lp, tok_lp), (st.top_v, topv), (st.top_i, topi)):
                buf.index_copy_(0, st.step, val[None])
        active = st.active != 0
        pos_eff = torch.where(active, st.pos, st.pos.clamp_max(self.max_seq_len - 1))
        lg, _ = forward(self.params, self.cfg, nxt[:, None].to(torch.int64), pos_eff[:, None],
                        self.memory.cache, pos_eff, st.valid_from, self.dtype,
                        kv_view_len=kv_view)
        st.logits.copy_(lg[:, -1, :])
        st.pos.add_(st.active)
        st.toks.index_copy_(0, st.step, nxt[None])
        st.step.add_(1)

    def decode_step(self, kv_view: int, want_probs: bool) -> None:
        """One decode step: a replay of the key's graph; for a new key, one
        eager step as the warm-up and the capture; eager without graphs."""
        if not self.cuda_graphs:
            self._step(kv_view, want_probs)
            return
        key = step_key(self.cfg, self.n_slots, kv_view, want_probs,
                       self.memory.cache.k.dtype, True, self.memory.cache.ring,
                       has_sinks(self.params))
        graph = self.graphs.get(key)
        if graph is None:
            self._warm_up_and_capture(key, kv_view, want_probs)
        else:
            graph.replay()

    def _warm_up_and_capture(self, key, kv_view: int, want_probs: bool) -> None:
        self._capture(key, lambda: self._step(kv_view, want_probs), (self._gen,))

    def _decode(self, n_steps: int, kv_view: int, want_probs: bool):
        """n_steps decode steps from the slots' positions and activity on the
        host. Returns host arrays (tokens (n_steps, B), and with want_probs
        the token logprob and the top-8 values and ids)."""
        st = self.state
        st.ctl.copy_(torch.from_numpy(np.concatenate(
            [self._pos, self._active.astype(np.int64), np.zeros(1, np.int64)])))
        with _cuda.counters_scope(self.counters):
            for _ in range(n_steps):
                self.decode_step(kv_view, want_probs)
        # the chunk's host reads, copied (on the CPU .numpy() shares the buffers)
        bufs = (st.toks, st.tok_lp, st.top_v, st.top_i) if want_probs else (st.toks,)
        return [b[:n_steps].cpu().numpy().copy() for b in bufs]

    def _decode_step(self):
        self._context_shift_overdue(self.decode_chunk)
        n_steps = self.decode_chunk
        want_probs = any(self._active[i] and self.rt[i].task.params.n_probs > 0
                         for i in range(self.n_slots))
        t0 = time.time()
        ys = self._decode(n_steps, self._kv_view_bucket(n_steps), want_probs)
        toks_np = ys[0]
        self.metrics["decode_seconds_total"] += time.time() - t0
        for i in range(self.n_slots):
            if not self._active[i]:
                continue
            n = toks_np.shape[0]
            self._pos[i] += n
            self.memory.slots[i].n_past = int(self._pos[i])
            self.metrics["generated_tokens_total"] += n
            probs = None
            if want_probs and self.rt[i].task.params.n_probs > 0:
                k = min(self.rt[i].task.params.n_probs, 8)
                probs = [{"logprob": float(ys[1][s, i]),
                          "top": [(int(ys[3][s, i, j]), float(ys[2][s, i, j]))
                                  for j in range(k)]} for s in range(n)]
            self._emit(i, toks_np[:, i].tolist(), probs)

    def _drain_ctrl(self):
        while True:
            try:
                fn, done = self._ctrl.get_nowait()
            except queue.Empty:
                return
            try:
                done.put(("ok", fn()))
            except Exception as e:
                done.put(("error", e))

    def _loop(self):
        # inference mode is per thread: enter it on the loop's own thread
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    self._drain_ctrl()
                    self._admit()
                    self.metrics["queue_depth"] = self.queue.qsize()
                    self.metrics["slots_busy"] = sum(r.task is not None for r in self.rt)
                    pending = [i for i, r in enumerate(self.rt) if r.task and r.pending]
                    for i in pending:
                        self._prefill_step(i)
                    if self._active.any():
                        self._decode_step()
                    elif not pending:
                        self._wake.wait(timeout=0.05)
                        self._wake.clear()
                except Exception as e:  # keep serving; fail the affected tasks
                    traceback.print_exc()
                    for i, r in enumerate(self.rt):
                        if r.task is not None:
                            r.task.out.put(("error", f"{type(e).__name__}: {e}"))
                            r.task = None
                            r.pending = []
                            self._active[i] = False
                            self.memory.clear_slot(i)

    # ------------------------------------------------------------- sync api

    def generate(self, tokens: list[int], params: GenParams | None = None) -> dict:
        """Blocking wrapper: submit and wait for the result."""
        task = Task(tokens=tokens, params=params or GenParams())
        self.submit(task)
        info = {}
        for kind, payload in task.events():
            if kind == "error":
                raise RuntimeError(payload)
            if kind == "done":
                info = payload
        return info
