"""The server's decode step, the function a CUDA graph captures on the card,
held on the CPU: the server against the JAX package's across chunk
boundaries, admissions between chunks and a context shift; sampled,
penalized, mirostat and logprob rows against the decode loop the server ran
before its step was captured (kept here as the oracle); no step buffer,
sampler row or penalty state ever rebound; the step key and the graph
bookkeeping over a server session; and each owner's own arrival counters.
Card-only checks of the graph itself are in tests/test_torch_gpu.py."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGMLType
from tpullm.runtime.loader import load_model as jload
from tpullm.server.context import GenParams as JGenParams
from tpullm.server.context import ServerContext as JServerContext
from tpullm.server.context import Task as JTask
from tpullm.utils.synth import build_llama_gguf
from tpullm_torch.models.llama import forward
from tpullm_torch.ops import _cuda, flash_decode, layer_kernel
from tpullm_torch.ops.sampling import BatchSamplerParams, PenaltyState, SamplerConfig, \
    sample_batch
from tpullm_torch.runtime.engine import InferenceEngine
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.server.context import GenParams, ServerContext, Task, step_key

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_server_graph") / "tiny_q4k.gguf")
    build_llama_gguf(path, vocab_size=512, n_embd=512, n_layer=2, n_head=4, n_head_kv=2,
                     n_ff=512, qtype=GGMLType.Q4_K, seed=11)
    jcfg, jparams, _ = jload(path)
    cfg, params, _ = load_model(path, device="cpu")
    return jcfg, jparams, cfg, params


KV = {"f32": (jnp.float32, torch.float32), "q8": ("q8", "q8")}


def _wait(ctx, tasks):
    """Submit every task at once (between two iterations of the loop, so
    they are admitted together) and wait until each is done -> [done
    payload]."""
    ctx.control(lambda: [ctx.submit(t) for t in tasks])
    out = []
    for t in tasks:
        done = [p for k, p in t.events() if k == "done"]
        assert done, "task failed"
        out.append(done[0])
    return out


def _serve(ctx, tasks):
    """One run of the loop over the tasks (a stopped loop does not start
    again)."""
    ctx.start()
    try:
        return _wait(ctx, tasks)
    finally:
        ctx.stop()


# (prompt, max_tokens): on 2 slots, the short third request waits for a slot
# and is admitted between chunks; the last one outgrows the 64-slot cache
# and shifts its context
GREEDY_RUN = [(list(range(3, 13)), 9), (list(range(40, 52)), 3), ([9, 8, 7, 6, 5, 4, 3, 2], 6),
              (list(range(100, 140)), 30)]


@pytest.mark.parametrize("kv", list(KV))
def test_server_matches_jax_across_chunks_admissions_and_shift(tiny, kv):
    """Greedy tokens equal the JAX ServerContext's (f32 compute, 2 slots,
    decode chunks of 4): requests that cross chunk boundaries, one admitted
    between chunks into a finished request's slot, and one whose context is
    shifted; both sides shift the same number of times."""
    jcfg, jparams, cfg, params = tiny
    common = dict(n_slots=2, max_seq_len=64, decode_chunk=4, prefill_chunk=8)
    jctx = JServerContext(jcfg, jparams, None, compute_dtype=jnp.float32,
                          kv_dtype=KV[kv][0], **common)
    tctx = ServerContext(cfg, params, None, compute_dtype=torch.float32, kv_dtype=KV[kv][1],
                         device="cpu", **common)
    want = _serve(jctx, [JTask(tokens=p, params=JGenParams(max_tokens=n, temperature=0.0))
                         for p, n in GREEDY_RUN])
    got = _serve(tctx, [Task(tokens=p, params=GenParams(max_tokens=n, temperature=0.0))
                        for p, n in GREEDY_RUN])
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    assert [len(g["tokens"]) for g in got] == [n for _, n in GREEDY_RUN]
    shifts = tctx.metrics.get("context_shifts_total", 0)
    assert shifts >= 1 and shifts == jctx.metrics.get("context_shifts_total", 0)


def legacy_decode(ctx, n_steps: int, kv_view: int, want_probs: bool):
    """The server's decode chunk as it ran before its step was captured: a
    Python loop of the step's ops that rebinds the carried logits, mu and
    positions each step (the oracle of the captured step)."""
    dev = ctx.device
    B, S = ctx.n_slots, ctx.max_seq_len
    pos = torch.from_numpy(ctx._pos).to(dev)
    active = torch.from_numpy(ctx._active).to(dev)
    vf = torch.zeros((B,), dtype=torch.int64, device=dev)
    logits, mu = ctx.state.logits.clone(), ctx.state.mu.clone()
    toks, lps = [], []
    for _ in range(n_steps):
        nxt, mu = sample_batch(logits, ctx.sparams, ctx._gen, ctx.penalties.counts, mu,
                               dry_ctx=ctx.penalties.ordered(), bias=ctx._bias)
        ctx.penalties.push(nxt)
        if want_probs:
            lp = torch.log_softmax(logits, dim=-1)
            topv, topi = torch.topk(lp, 8, dim=-1)
            tok_lp = torch.gather(lp, -1, nxt[:, None].to(torch.int64))[:, 0]
            lps.append((tok_lp, topv, topi))
        pos_eff = torch.where(active, pos, pos.clamp_max(S - 1))
        lg, _ = forward(ctx.params, ctx.cfg, nxt[:, None].to(torch.int64), pos_eff[:, None],
                        ctx.memory.cache, pos_eff, vf, ctx.dtype, kv_view_len=kv_view)
        logits = lg[:, -1, :]
        pos = pos + active.to(torch.int64)
        toks.append(nxt)
    ctx.state.logits.copy_(logits)
    ctx.state.mu.copy_(mu)
    out = [torch.stack(toks).numpy()]
    if want_probs:
        out += [torch.stack([x[j] for x in lps]).numpy() for j in range(3)]
    return out


SAMPLED_RUN = [  # (prompt, GenParams kwargs): 5 requests on 2 slots
    (list(range(3, 15)), dict(max_tokens=7, temperature=0.9, top_k=20, top_p=0.9, seed=5,
                              n_probs=3)),
    (list(range(50, 59)), dict(max_tokens=6, temperature=0.0, penalty_repeat=1.3,
                               penalty_freq=0.2, penalty_present=0.1, dry_multiplier=0.8,
                               n_probs=2, seed=1)),
    ([7, 7, 8, 7, 7, 8, 7], dict(max_tokens=9, temperature=1.0, mirostat=2, mirostat_tau=4.0,
                                 seed=9)),
    (list(range(200, 205)), dict(max_tokens=5, temperature=0.7, mirostat=1, seed=2,
                                 logit_bias={"17": 3.0, "18": False})),
    (list(range(300, 311)), dict(max_tokens=8, temperature=1.2, top_k=5, min_p=0.05,
                                 dry_multiplier=0.5, penalty_repeat=1.1, seed=4, n_probs=8)),
]


@pytest.mark.parametrize("kv", list(KV))
def test_sampled_and_logprob_rows_match_the_pre_graph_loop(tiny, kv, monkeypatch):
    """Rows with top-k / top-p, penalties, DRY, mirostat v1 and v2, a logit
    bias and logprobs give the same tokens and logprobs as the decode loop
    the server ran before its step was captured, at the same seeds."""
    _, _, cfg, params = tiny
    common = dict(n_slots=2, max_seq_len=64, decode_chunk=4, prefill_chunk=8,
                  compute_dtype=torch.float32, kv_dtype=KV[kv][1], device="cpu")
    new, old = ServerContext(cfg, params, None, **common), ServerContext(cfg, params, None,
                                                                         **common)
    monkeypatch.setattr(old, "_decode", lambda *a: legacy_decode(old, *a))
    mk = lambda: [Task(tokens=p, params=GenParams(**kw)) for p, kw in SAMPLED_RUN]
    got, want = _serve(new, mk()), _serve(old, mk())
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    assert [g.get("logprobs") for g in got] == [w.get("logprobs") for w in want]
    assert [len(g["tokens"]) for g in got] == [kw["max_tokens"] for _, kw in SAMPLED_RUN]
    assert len(got[0]["logprobs"]) == 7 and len(got[0]["logprobs"][0]["top"]) == 3
    assert 18 not in got[3]["tokens"]


def _pointers(ctx):
    """Every tensor a captured step reads or writes -> its data_ptr."""
    st = ctx.state
    out = {f"state.{k}": v.data_ptr() for k, v in vars(st).items()}
    out.update({f"sparams.{k}": v.data_ptr() for k, v in vars(ctx.sparams).items()})
    out.update({f"penalties.{k}": getattr(ctx.penalties, k).data_ptr()
                for k in ("counts", "ring", "pos")})
    cache = ctx.memory.cache
    out.update({f"cache.{k}": getattr(cache, k).data_ptr() for k in ("k", "v", "ks", "vs")
                if getattr(cache, k) is not None})
    out.update({f"counters.{k}": v.data_ptr() for k, v in ctx.counters.items()})
    out["bias"] = ctx._bias.data_ptr()
    out["objects"] = (id(ctx.state), id(ctx.sparams), id(ctx.penalties), id(ctx.memory.cache))
    return out


@pytest.mark.parametrize("kv", list(KV))
def test_no_step_buffer_is_rebound(tiny, kv, monkeypatch):
    """Across chunks, admissions (new sampler rows, a bias row, reseeds),
    finishes and a context shift, every ServerDecodeState tensor, every
    sampler field, the penalty ring, counts and write index, the bias, the
    cache and the arrival counters keep their storage: a captured step would
    otherwise go on reading the old ones."""
    _, _, cfg, params = tiny
    ctx = ServerContext(cfg, params, None, n_slots=2, max_seq_len=64, decode_chunk=4,
                        prefill_chunk=8, compute_dtype=torch.float32, kv_dtype=KV[kv][1],
                        device="cpu")
    first = _pointers(ctx)
    seen = []
    real = ctx._decode

    def watched(*a):
        seen.append(_pointers(ctx))
        out = real(*a)
        seen.append(_pointers(ctx))
        return out

    monkeypatch.setattr(ctx, "_decode", watched)
    tasks = [Task(tokens=p, params=GenParams(**kw)) for p, kw in SAMPLED_RUN]
    tasks.append(Task(tokens=list(range(100, 140)), params=GenParams(max_tokens=30,
                                                                    temperature=0.0)))
    _serve(ctx, tasks)
    assert ctx.metrics.get("context_shifts_total", 0) >= 1
    assert len(seen) > 20
    for p in seen + [_pointers(ctx)]:
        assert p == first


class _FakeGraph:
    def __init__(self, run):
        self.run = run

    def replay(self):
        self.run()


def test_step_key_and_graph_bookkeeping(tiny, monkeypatch):
    """The graph bookkeeping of a server session on the CPU, with the capture
    replaced by an eager step and a graph whose replay runs the step: a key
    is captured at its first step and replayed after; the keys are (slots,
    kv view, logprobs or not, route) and change with the view, with
    logprobs and with TPULLM_FLASH_DECODE, never with an admission's
    sampler; the tokens equal an eager server's."""
    _, _, cfg, params = tiny
    common = dict(n_slots=2, max_seq_len=1024, decode_chunk=4, prefill_chunk=512,
                  compute_dtype=torch.float32, kv_dtype="q8", device="cpu")
    ctx, ref = ServerContext(cfg, params, None, **common), ServerContext(cfg, params, None,
                                                                         **common)
    captured, replays = [], []

    def capture(key, kv_view, want_probs):
        ctx._step(kv_view, want_probs)  # the warm-up: a real step
        captured.append(key)
        ctx.graphs[key] = _FakeGraph(lambda: (replays.append(key),
                                              ctx._step(kv_view, want_probs)))

    monkeypatch.setattr(ctx, "_warm_up_and_capture", capture)
    ctx.cuda_graphs = True
    ctx.start()
    ref.start()
    try:
        _bookkeeping_sessions(ctx, ref, cfg, captured, replays, monkeypatch)
    finally:
        ctx.stop()
        ref.stop()
    assert len(set(captured)) == len(captured)
    q8 = ctx.memory.cache.k.dtype
    assert captured == [(2, 512, False, "einsum"), (2, 512, True, "einsum"),
                        (2, 512, False, "flash_decode"), (2, 1024, False, "flash_decode"),
                        (2, 1024, False, "einsum")]
    assert captured[0] == step_key(cfg, 2, 512, False, q8, True)
    assert step_key(cfg, 2, 512, False, q8, False)[3] == "einsum"
    assert not ref.graphs


def _bookkeeping_sessions(ctx, ref, cfg, captured, replays, monkeypatch):
    """Five sessions on both running servers; each one's tokens equal, with
    replays and at most two new captures a session."""
    g = np.random.default_rng(5)
    sessions = [  # (prompt lengths and GenParams kwargs, flag); every seed set, as the
        # draw stream folds in each admitted request's
        ([(20, dict(max_tokens=9, temperature=0.0, seed=0)),
          (30, dict(max_tokens=9, temperature=0.8, seed=3))], None),
        ([(20, dict(max_tokens=6, temperature=0.0, n_probs=2, seed=0)),
          (9, dict(max_tokens=6, temperature=0.0, penalty_repeat=1.2, seed=0))], None),
        ([(20, dict(max_tokens=6, temperature=0.0, seed=0))], "1"),
        ([(600, dict(max_tokens=6, temperature=0.0, seed=0))], "1"),
        ([(600, dict(max_tokens=6, temperature=0.5, seed=1))], None),
    ]
    for reqs, flag in sessions:
        if flag:
            monkeypatch.setenv("TPULLM_FLASH_DECODE", flag)
        else:
            monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
        prompts = [g.integers(0, cfg.vocab_size, n).tolist() for n, _ in reqs]
        mk = lambda: [Task(tokens=p, params=GenParams(**kw)) for p, (_, kw) in
                      zip(prompts, reqs)]
        n_cap, n_rep = len(captured), len(replays)
        got, want = _wait(ctx, mk()), _wait(ref, mk())
        assert [x["tokens"] for x in got] == [x["tokens"] for x in want]
        assert len(replays) > n_rep
        assert len(captured) - n_cap <= 2


def test_sampler_rows_and_penalties_update_in_place():
    """set_row_ writes a row into the same tensors and equals the JAX call
    shape with_row (which copies); a penalty push advances the ring's write
    index in place."""
    a = BatchSamplerParams.neutral(3)
    ptrs = {k: v.data_ptr() for k, v in vars(a).items()}
    cfg = SamplerConfig(temperature=0.7, top_k=5, mirostat_tau=4.0, mirostat_v=1,
                        dry_allowed=3, penalty_repeat=1.2)
    b = a.with_row(1, cfg)
    assert a.set_row_(1, cfg) is a
    assert {k: v.data_ptr() for k, v in vars(a).items()} == ptrs
    assert all(torch.equal(getattr(a, k), getattr(b, k)) for k in ptrs)
    assert float(a.temperature[1]) == pytest.approx(0.7) and int(a.top_k[1]) == 5
    pen = PenaltyState.create(2, 10, window=3)
    pos = pen.pos
    for t in ([1, 2], [3, 4], [5, 6], [7, 8]):
        assert pen.push(torch.tensor(t)) is pen
    assert pen.pos is pos and pen.pos.tolist() == [1, 1]
    assert pen.ordered().tolist() == [[3, 5, 7], [4, 6, 8]]


def test_each_owner_has_its_own_counters(tiny, monkeypatch):
    """Every ServerContext and each engine decode state make their own D and
    E arrival counters, sized for their slots and cache; a thread's
    counters_scope hands its own buffers to the kernels' wrappers (E's too
    small raises), another thread's scope is its own, and outside any scope
    the wrappers fall back to the device's shared buffer."""
    _, _, cfg, params = tiny
    a = ServerContext(cfg, params, None, n_slots=2, max_seq_len=512, device="cpu")
    b = ServerContext(cfg, params, None, n_slots=4, max_seq_len=2048, device="cpu")
    eng = InferenceEngine(cfg, params, max_seq_len=256, device="cpu")
    owners = [a.counters, b.counters, eng.decode_state(3).counters]
    ptrs = [t.data_ptr() for o in owners for t in o.values()]
    assert len(set(ptrs)) == len(ptrs)
    for o, (B, S) in zip(owners, ((2, 512), (4, 2048), (3, 256))):
        assert o["layer_kernel"].numel() == layer_kernel.N_COUNTERS
        assert o["flash_decode"].numel() == B * cfg.n_head_kv * flash_decode.counters_per_row(
            S, False) >= B * cfg.n_head_kv * flash_decode.counters_per_row(S, True)
        assert all(int(t.abs().sum()) == 0 for t in o.values())
    dev = torch.device("cuda", 0)
    seen = {}
    barrier = threading.Barrier(2)

    def use(name, owned):
        with _cuda.counters_scope(owned):
            barrier.wait()
            seen[name] = (flash_decode._counters(dev, 8), _cuda.scoped_counters("layer_kernel"))
            barrier.wait()

    threads = [threading.Thread(target=use, args=(n, o)) for n, o in (("a", a.counters),
                                                                    ("b", b.counters))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for name, o in (("a", a.counters), ("b", b.counters)):
        assert seen[name][0] is o["flash_decode"] and seen[name][1] is o["layer_kernel"]
    assert _cuda.scoped_counters("flash_decode") is None
    with _cuda.counters_scope(a.counters), pytest.raises(ValueError, match="arrival"):
        flash_decode._counters(dev, a.counters["flash_decode"].numel() + 1)
    shared = torch.zeros(1024, dtype=torch.int32)
    monkeypatch.setitem(flash_decode._COUNTERS, 0, shared)
    assert flash_decode._counters(dev, 8) is shared
