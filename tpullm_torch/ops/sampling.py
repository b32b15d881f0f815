"""Sampler chain on the device.

Counterpart of tpullm/ops/sampling.py: ``SamplerConfig``, ``GREEDY`` and
``make_sample_fn`` with the stages it chains (penalties -> top_n_sigma ->
top_k -> typical_p -> top_p -> min_p -> xtc -> temperature -> draw). Every
transform maps (B, V) f32 logits to logits with dropped candidates at
-inf. Draws use a ``torch.Generator``; its stream differs from the JAX
PRNG's, so only greedy decoding matches the JAX package token for token.

The server's per-row sampler (sampling.py:186-484): ``BatchSamplerParams``
holds every parameter as a (B,) tensor, so one call serves slots with
different settings; ``sample_batch`` runs the chain on the top-256
candidates of one top-k; ``apply_dry`` and ``PenaltyState`` (the last-N
token ring and counts) feed its penalties.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

NEG_INF = float("-inf")


@dataclass(frozen=True)
class SamplerConfig:
    """Static sampler parameters."""

    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0
    min_p: float = 0.0
    typical_p: float = 1.0
    top_n_sigma: float = 0.0
    xtc_probability: float = 0.0
    xtc_threshold: float = 0.1
    penalty_repeat: float = 1.0
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    mirostat_tau: float = 0.0
    mirostat_eta: float = 0.1
    mirostat_v: int = 2
    dry_multiplier: float = 0.0
    dry_base: float = 1.75
    dry_allowed: int = 2
    greedy: bool = False

    @property
    def needs_penalties(self) -> bool:
        return (
            self.penalty_repeat != 1.0
            or self.penalty_freq != 0.0
            or self.penalty_present != 0.0
        )


def _masked(logits, drop):
    return torch.where(drop, torch.full_like(logits, NEG_INF), logits)


def apply_penalties(logits, counts, cfg: SamplerConfig):
    """counts: (B, V) occurrences in the penalty window."""
    used = counts > 0
    rep = torch.where(logits <= 0, logits * cfg.penalty_repeat,
                      logits / cfg.penalty_repeat)
    out = torch.where(used, rep, logits)
    return out - counts * cfg.penalty_freq - used.to(torch.float32) * cfg.penalty_present


def apply_top_k(logits, k: int):
    if k <= 0:
        return logits
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return _masked(logits, logits < kth)


def apply_top_p(logits, p: float):
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    keep_sorted = torch.cat(
        [torch.ones_like(cum[..., :1], dtype=torch.bool), cum[..., :-1] < p], dim=-1)
    n_keep = keep_sorted.sum(dim=-1, keepdim=True)
    kth = torch.gather(sorted_logits, -1, n_keep - 1)
    return _masked(logits, logits < kth)


def apply_min_p(logits, p: float):
    if p <= 0.0:
        return logits
    mx = logits.max(dim=-1, keepdim=True).values
    return _masked(logits, logits < mx + torch.log(torch.tensor(p)))


def apply_typical(logits, p: float):
    if p >= 1.0:
        return logits
    logp = torch.log_softmax(logits, dim=-1)
    probs = torch.exp(logp)
    ent = -(probs * torch.where(probs > 0, logp, torch.zeros_like(logp))).sum(
        dim=-1, keepdim=True)
    shifted = torch.abs(-logp - ent)
    order = torch.argsort(shifted, dim=-1)
    sorted_probs = torch.gather(probs, -1, order)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = torch.cat(
        [torch.ones_like(cum[..., :1], dtype=torch.bool), cum[..., :-1] < p], dim=-1)
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return _masked(logits, ~keep)


def apply_top_n_sigma(logits, n: float):
    if n <= 0.0:
        return logits
    mx = logits.max(dim=-1, keepdim=True).values
    valid = logits > NEG_INF
    cnt = valid.sum(dim=-1, keepdim=True)
    zero = torch.zeros_like(logits)
    mean = torch.where(valid, logits, zero).sum(-1, keepdim=True) / cnt
    var = (torch.where(valid, logits - mean, zero) ** 2).sum(-1, keepdim=True) / cnt
    return _masked(logits, logits < mx - n * torch.sqrt(var))


def apply_xtc(logits, generator, probability: float, threshold: float):
    """Exclude-the-top-choice sampler (llama.cpp llama_sampler_xtc)."""
    if probability <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    above = probs >= threshold
    n_above = above.sum(dim=-1, keepdim=True)
    min_above = torch.where(above, probs, torch.full_like(probs, float("inf"))).min(
        dim=-1, keepdim=True).values
    drop = above & (probs > min_above) & (n_above >= 2)
    roll = torch.rand((logits.shape[0], 1), generator=generator, device=logits.device)
    return _masked(logits, (roll < probability) & drop)


def apply_temperature(logits, t: float):
    if t <= 0.0:
        mx = logits.max(dim=-1, keepdim=True).values
        return _masked(logits, logits < mx)
    return logits / t


def make_sample_fn(cfg: SamplerConfig):
    """-> (logits (B,V), generator, counts (B,V) | None) -> tokens (B,) int32."""

    def fn(logits, generator=None, counts=None):
        logits = logits.to(torch.float32)
        if cfg.greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        if cfg.needs_penalties and counts is not None:
            logits = apply_penalties(logits, counts, cfg)
        if cfg.top_n_sigma > 0:
            logits = apply_top_n_sigma(logits, cfg.top_n_sigma)
        logits = apply_top_k(logits, cfg.top_k)
        logits = apply_typical(logits, cfg.typical_p)
        logits = apply_top_p(logits, cfg.top_p)
        logits = apply_min_p(logits, cfg.min_p)
        if cfg.xtc_probability > 0:
            logits = apply_xtc(logits, generator, cfg.xtc_probability, cfg.xtc_threshold)
        logits = apply_temperature(logits, cfg.temperature)
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)

    return fn


GREEDY = SamplerConfig(greedy=True)


@dataclass
class BatchSamplerParams:
    """Per-row sampler parameters, each a (B,) tensor. Neutral values disable
    a stage for a row (top_k 0, top_p 1, min_p 0, typical_p 1, top_n_sigma 0,
    xtc_probability 0, penalty_repeat 1 / freq 0 / present 0, mirostat_tau
    0, dry_multiplier 0); temperature <= 0 is greedy."""

    temperature: torch.Tensor
    top_k: torch.Tensor  # int32
    top_p: torch.Tensor
    min_p: torch.Tensor
    typical_p: torch.Tensor
    top_n_sigma: torch.Tensor
    xtc_probability: torch.Tensor
    xtc_threshold: torch.Tensor
    penalty_repeat: torch.Tensor
    penalty_freq: torch.Tensor
    penalty_present: torch.Tensor
    mirostat_tau: torch.Tensor
    mirostat_eta: torch.Tensor
    mirostat_v: torch.Tensor  # int32: 1 | 2
    dry_multiplier: torch.Tensor
    dry_base: torch.Tensor
    dry_allowed: torch.Tensor  # int32

    _INT = ("top_k", "mirostat_v", "dry_allowed")

    @staticmethod
    def neutral(B: int, device="cpu") -> "BatchSamplerParams":
        vals = dict(temperature=0.0, top_k=0, top_p=1.0, min_p=0.0, typical_p=1.0,
                    top_n_sigma=0.0, xtc_probability=0.0, xtc_threshold=0.1,
                    penalty_repeat=1.0, penalty_freq=0.0, penalty_present=0.0,
                    mirostat_tau=0.0, mirostat_eta=0.1, mirostat_v=2,
                    dry_multiplier=0.0, dry_base=1.75, dry_allowed=2)
        return BatchSamplerParams(**{
            k: torch.full((B,), v, device=device,
                          dtype=torch.int32 if k in BatchSamplerParams._INT else torch.float32)
            for k, v in vals.items()})

    def with_row(self, i: int, cfg: SamplerConfig) -> "BatchSamplerParams":
        """A copy with row i set from a SamplerConfig (the JAX call shape)."""
        new = BatchSamplerParams(**{f.name: getattr(self, f.name).clone()
                                    for f in dataclasses.fields(self)})
        return new.set_row_(i, cfg)

    def set_row_(self, i: int, cfg: SamplerConfig) -> "BatchSamplerParams":
        """Row i set from a SamplerConfig in place, so that a captured step,
        which keeps every field's tensor, reads the new row."""
        vals = dict(
            temperature=0.0 if cfg.greedy else cfg.temperature, top_k=cfg.top_k,
            top_p=cfg.top_p, min_p=cfg.min_p, typical_p=cfg.typical_p,
            top_n_sigma=cfg.top_n_sigma, xtc_probability=cfg.xtc_probability,
            xtc_threshold=cfg.xtc_threshold, penalty_repeat=cfg.penalty_repeat,
            penalty_freq=cfg.penalty_freq, penalty_present=cfg.penalty_present,
            mirostat_tau=cfg.mirostat_tau, mirostat_eta=cfg.mirostat_eta,
            mirostat_v=cfg.mirostat_v, dry_multiplier=cfg.dry_multiplier,
            dry_base=cfg.dry_base, dry_allowed=cfg.dry_allowed)
        for f in dataclasses.fields(self):
            getattr(self, f.name)[i] = vals[f.name]
        return self


def _col(x):
    return x[:, None]


def apply_dry(logits, ordered, p: BatchSamplerParams, max_match: int = 16):
    """DRY repetition penalty (llama_sampler_dry), over ordered (B, N)
    recent tokens oldest to newest (-1 = empty): the token that would extend
    a repeat of length m >= allowed is penalized by multiplier *
    base^(m - allowed), the largest per token id."""
    B, N = ordered.shape
    V = logits.shape[-1]
    dev = ordered.device
    js = torch.arange(max_match, device=dev)
    idx_ctx = torch.arange(N, device=dev)[:, None] - 1 - js[None, :]  # (N, J)
    valid = idx_ctx >= 0
    ctx = ordered[:, idx_ctx.clamp_min(0)]  # (B, N, J)
    tail = ordered[:, N - 1 - js][:, None, :]  # (B, 1, J)
    eq = (ctx == tail) & valid[None] & (ctx >= 0)
    m = torch.cumprod(eq.to(torch.int32), dim=-1).sum(-1)  # (B, N)
    pen_exp = m - _col(p.dry_allowed) + 1
    pen = torch.where((pen_exp > 0) & (ordered >= 0),
                      _col(p.dry_multiplier) * _col(p.dry_base) ** (pen_exp - 1).to(torch.float32),
                      torch.zeros((), device=dev))
    out = torch.zeros((B, V), dtype=logits.dtype, device=dev)
    out = out.scatter_reduce(1, ordered.clamp_min(0).to(torch.int64), pen.to(logits.dtype),
                             reduce="amax", include_self=True)
    return logits - out


def sample_batch(logits, p: BatchSamplerParams, generator=None, counts=None, mu=None,
                 dry_ctx=None, bias=None):
    """(B, V) logits + per-row params -> (B,) int32 tokens, or (tokens, new
    mu) when ``mu`` is given. Chain order: bias, penalties, DRY, then on the
    top K = 256 candidates top_n_sigma (full-vocab statistics), top_k,
    typical_p, top_p, min_p, xtc, mirostat (rows with mirostat_tau > 0
    bypass the truncation stack), temperature or greedy, draw."""
    logits = logits.to(torch.float32)
    if bias is not None:
        logits = logits + bias
    B, V = logits.shape
    dev = logits.device
    raw = logits
    if counts is not None:
        used = counts > 0
        rep = torch.where(logits <= 0, logits * _col(p.penalty_repeat),
                          logits / _col(p.penalty_repeat))
        logits = torch.where(used, rep, logits)
        logits = (logits - counts * _col(p.penalty_freq)
                  - used.to(torch.float32) * _col(p.penalty_present))
    if dry_ctx is not None:
        logits = apply_dry(logits, dry_ctx, p)

    K = min(256, V)
    ninf = torch.full((), NEG_INF, device=dev)  # a fill, not a copy: a capture takes it
    mx_full = logits.amax(-1, keepdim=True)
    mean = logits.mean(-1, keepdim=True)
    std = torch.sqrt(((logits - mean) ** 2).mean(-1, keepdim=True).clamp_min(0.0))
    vals, idx = torch.topk(logits, K, dim=-1)  # descending
    pos = torch.arange(K, device=dev)[None, :]

    thr = torch.where(_col(p.top_n_sigma) > 0, mx_full - _col(p.top_n_sigma) * std, ninf)
    vals = torch.where(vals < thr, ninf, vals)

    kk = torch.where(p.top_k > 0, p.top_k.clamp_max(K), K)
    vals = torch.where(pos >= _col(kk), ninf, vals)

    # typical_p over the candidates left so far
    logp = torch.log_softmax(vals, dim=-1)
    probs = torch.exp(logp)
    ent = -(probs * torch.where(probs > 0, logp, torch.zeros_like(logp))).sum(-1, keepdim=True)
    order = torch.argsort(torch.abs(-logp - ent), dim=-1, stable=True)
    cum = torch.cumsum(torch.gather(probs, -1, order), dim=-1)
    keep_sorted = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool),
                             cum[:, :-1] < _col(p.typical_p)], dim=-1)
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    vals = torch.where(keep | (_col(p.typical_p) >= 1.0), vals, ninf)

    # top_p (typical may mask any position: sort the candidates again)
    sd = torch.sort(vals, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sd, dim=-1), dim=-1)
    keep_sorted = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool),
                             cum[:, :-1] < _col(p.top_p)], dim=-1)
    kth = torch.gather(sd, -1, keep_sorted.sum(-1, keepdim=True) - 1)
    vals = torch.where((vals < kth) & (_col(p.top_p) < 1.0), ninf, vals)

    mx = vals.amax(-1, keepdim=True)
    minp_thr = torch.where(_col(p.min_p) > 0, mx + torch.log(_col(p.min_p)), ninf)
    vals = torch.where(vals < minp_thr, ninf, vals)

    probs = torch.softmax(vals, dim=-1)
    above = probs >= _col(p.xtc_threshold)
    n_above = above.sum(-1, keepdim=True)
    min_above = torch.where(above, probs, torch.full_like(probs, float("inf"))).amin(
        -1, keepdim=True)
    drop = above & (probs > min_above) & (n_above >= 2)
    roll = torch.rand((B, 1), generator=generator, device=dev)
    vals = torch.where((roll < _col(p.xtc_probability)) & drop, ninf, vals)

    if mu is not None:
        tau_on = _col(p.mirostat_tau) > 0
        lse_raw = torch.logsumexp(raw, dim=-1, keepdim=True)
        vals_raw = torch.gather(raw, -1, idx)
        surprise = (lse_raw - vals_raw) / math.log(2.0)
        miro_vals = torch.where(surprise > _col(mu), ninf, vals_raw)
        miro_vals = torch.where(vals_raw >= vals_raw.amax(-1, keepdim=True), vals_raw,
                                miro_vals)
        m_pairs = min(99, K - 1)
        lp_s = torch.log_softmax(torch.sort(vals_raw, dim=-1, descending=True).values, dim=-1)
        i_ar = torch.arange(m_pairs, device=dev, dtype=torch.float32)
        t_i = torch.log((i_ar + 2.0) / (i_ar + 1.0))[None, :]
        b_i = lp_s[:, :m_pairs] - lp_s[:, 1: m_pairs + 1]
        s_hat = (t_i * b_i).sum(-1) / (t_i * t_i).sum(-1).clamp_min(1e-9)
        eps_hat = (s_hat - 1.0).clamp_min(1e-4)
        k1 = ((eps_hat * torch.exp2(mu)) / (1.0 - float(V) ** (-eps_hat))) ** (1.0 / s_hat)
        k1 = k1.clamp(1, K)
        v1_vals = torch.where(pos < k1[:, None], vals_raw, ninf)
        use_v1 = tau_on & (_col(p.mirostat_v) == 1)
        vals = torch.where(use_v1, v1_vals, torch.where(tau_on, miro_vals, vals))

    greedy_mask = torch.where(vals < vals.amax(-1, keepdim=True), ninf, vals)
    t = _col(p.temperature)
    vals = torch.where(t > 0, vals / torch.where(t > 0, t, torch.ones_like(t)), greedy_mask)
    # a categorical draw as the argmax of vals plus Gumbel noise
    u = torch.rand((B, K), generator=generator, device=dev).clamp_min(
        torch.finfo(torch.float32).tiny)
    j = torch.argmax(vals - torch.log(-torch.log(u)), dim=-1, keepdim=True)
    toks = torch.gather(idx, -1, j)[:, 0].to(torch.int32)
    if mu is None:
        return toks
    lse = torch.logsumexp(raw, dim=-1)
    obs = (lse - torch.gather(raw, -1, toks[:, None].to(torch.int64))[:, 0]) / math.log(2.0)
    new_mu = mu - p.mirostat_eta * (obs - p.mirostat_tau)
    return toks, torch.where(p.mirostat_tau > 0, new_mu, mu)


@dataclass
class PenaltyState:
    """Ring of the last N accepted tokens per row and their counts (the
    llama_sampler_penalties window). ``push`` and ``clear_row`` update the
    tensors in place and return the state, so the JAX call shape
    ``pen = pen.push(tokens)`` holds."""

    counts: torch.Tensor  # (B, V) int32
    ring: torch.Tensor  # (B, N) int32, -1 = empty
    pos: torch.Tensor  # (B,) int64, next write index

    @staticmethod
    def create(B: int, V: int, window: int = 64, device="cpu") -> "PenaltyState":
        return PenaltyState(torch.zeros((B, V), dtype=torch.int32, device=device),
                            torch.full((B, window), -1, dtype=torch.int32, device=device),
                            torch.zeros((B,), dtype=torch.int64, device=device))

    def push(self, tokens) -> "PenaltyState":
        """Accept one token per row; the oldest beyond the window leaves."""
        B, N = self.ring.shape
        rows = torch.arange(B, device=self.ring.device)
        old = self.ring[rows, self.pos]
        self.counts.index_put_((rows, old.clamp_min(0).to(torch.int64)),
                               -(old >= 0).to(torch.int32), accumulate=True)
        self.counts.index_put_((rows, tokens.to(torch.int64)),
                               torch.ones_like(rows, dtype=torch.int32), accumulate=True)
        self.ring[rows, self.pos] = tokens.to(torch.int32)
        self.pos.add_(1).remainder_(N)  # in place: a captured step keeps this tensor
        return self

    def clear_row(self, i: int) -> "PenaltyState":
        self.counts[i] = 0
        self.ring[i] = -1
        self.pos[i] = 0
        return self

    def ordered(self):
        """(B, N) tokens oldest to newest (-1 where empty)."""
        N = self.ring.shape[1]
        idx = (torch.arange(N, device=self.ring.device)[None, :] + self.pos[:, None]) % N
        return torch.gather(self.ring, 1, idx)
