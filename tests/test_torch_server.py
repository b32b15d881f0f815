"""The port's server slice against the JAX package on the CPU: SlotMemory's
bookkeeping and context shift, the per-row sampler's pieces, a port
ServerContext against a JAX one (tokenizer None) on the same weights, and
the port's HTTP front end driven with urllib. Inputs come from numpy
seeds and are handed to both sides."""
import json
import socket
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGMLType
from tpullm.models.config import ModelConfig as JConfig
from tpullm.models.llama import KVCache as JKVCache
from tpullm.ops import sampling as jsamp
from tpullm.runtime.loader import load_model as jload
from tpullm.runtime.memory import SlotMemory as JSlotMemory
from tpullm.server.context import GenParams as JGenParams
from tpullm.server.context import ServerContext as JServerContext
from tpullm.server.context import Task as JTask
from tpullm.utils.synth import build_llama_gguf
from tpullm_torch.models.config import ModelConfig
from tpullm_torch.ops import sampling as tsamp
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.runtime.memory import SlotMemory
from tpullm_torch.server.context import GenParams, ServerContext, Task
from tpullm_torch.server.http import serve
from tpullm_torch.utils.from_jax import kv_cache_from_numpy

torch.set_num_threads(2)


def _nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / max((b ** 2).mean(), 1e-30))


def _mem_cfg():
    kw = dict(arch="llama", n_layer=2, n_head=2, n_head_kv=2, head_dim=128, head_dim_v=128,
              n_embd=256, rope_dim=128)
    return JConfig(**kw), ModelConfig(**kw)


def _cache_np(a):
    return None if a is None else np.asarray(a)


def _mems(kv, n_slots=3, S=32, seed=0):
    """A JAX and a port SlotMemory holding the same random cache content."""
    jcfg, cfg = _mem_cfg()
    jm = JSlotMemory(jcfg, n_slots, S, {"bf16": jnp.bfloat16, "f32": jnp.float32,
                                        "q8": "q8"}[kv])
    rng = np.random.default_rng(seed)
    shape = jm.cache.k.shape
    if kv == "q8":
        parts = (rng.integers(-127, 128, shape).astype(np.int8),
                 rng.integers(-127, 128, shape).astype(np.int8),
                 (rng.random(shape[:-1]) * 0.02).astype(np.float32),
                 (rng.random(shape[:-1]) * 0.02).astype(np.float32))
        jm.cache = JKVCache(*(jnp.asarray(p) for p in parts))
    else:
        dt = jm.cache.k.dtype
        jm.cache = JKVCache(jnp.asarray(rng.standard_normal(shape), dt),
                            jnp.asarray(rng.standard_normal(shape), dt))
    m = SlotMemory(cfg, n_slots, S, {"bf16": torch.bfloat16, "f32": torch.float32,
                                     "q8": "q8"}[kv], device="cpu")
    m.cache = kv_cache_from_numpy(*(_cache_np(a) for a in (jm.cache.k, jm.cache.v,
                                                           jm.cache.ks, jm.cache.vs)),
                                  device="cpu")
    return jm, m


def _same_state(jm, m):
    for js, ts in zip(jm.slots, m.slots):
        assert (js.n_past, js.tokens) == (ts.n_past, ts.tokens)


def test_slot_bookkeeping_matches_jax():
    jm, m = _mems("bf16")
    for mem in (jm, m):
        mem.slots[0].tokens = [1, 2, 3, 4, 5]
        mem.slots[0].n_past = 5
    for toks in ([1, 2, 3, 9, 9], [1, 2, 3, 4, 5], [1, 2, 3, 4, 5, 6, 7], [7], [1]):
        assert m.prefix_match(0, toks) == jm.prefix_match(0, toks), toks
    for mem in (jm, m):
        mem.truncate(0, 2)
        mem.copy_slot(0, 2)
    _same_state(jm, m)
    for a, b in ((m.cache.k, jm.cache.k), (m.cache.v, jm.cache.v)):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
    assert torch.equal(m.cache.k[:, 2], m.cache.k[:, 0])
    for mem in (jm, m):
        mem.clear_slot(0)
    _same_state(jm, m)


def test_copy_slot_q8_matches_jax():
    jm, m = _mems("q8")
    for mem in (jm, m):
        mem.slots[1].tokens, mem.slots[1].n_past = [4, 4], 2
        mem.copy_slot(1, 0)
    _same_state(jm, m)
    for a, b in ((m.cache.k, jm.cache.k), (m.cache.ks, jm.cache.ks)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kv", ["f32", "bf16", "q8"])
def test_context_shift_matches_jax(kv):
    """Roll and re-rope of slot 1 (n_keep 5, n_discard 9 of n_past 27).
    Unmoved rows: identical (bf16/f32); the moved K rows were rotated on
    both sides from the same bf16 values with cos/sin computed by two
    libraries, so they agree to NMSE < 1e-5. q8 caches are dequantized,
    shifted and requantized on both sides: the dequantized rows agree to
    NMSE < 1e-5 (a value on a rounding boundary may move one int8 step)."""
    jm, m = _mems(kv, seed=3)
    for mem in (jm, m):
        mem.slots[1].tokens = list(range(27))
        mem.slots[1].n_past = 27
        mem.context_shift(1, 5, 9)
    _same_state(jm, m)

    def deq(k, ks):
        k = np.asarray(k, np.float32) if not torch.is_tensor(k) else k.float().numpy()
        if ks is None:
            return k
        ks = np.asarray(ks) if not torch.is_tensor(ks) else ks.numpy()
        return k * ks[..., None]

    kj, kt = deq(jm.cache.k, jm.cache.ks), deq(m.cache.k, m.cache.ks)
    vj, vt = deq(jm.cache.v, jm.cache.vs), deq(m.cache.v, m.cache.vs)
    assert _nmse(kt, kj) < 1e-5 and _nmse(vt, vj) < 1e-5
    if kv != "q8":
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(kt[:, 1, :, :5], kj[:, 1, :, :5])
        np.testing.assert_array_equal(kt[:, 1, :, 18:], kj[:, 1, :, 18:])
        np.testing.assert_array_equal(kt[:, 0], kj[:, 0])


def _sampler_rows(B):
    """Per-row configs: greedy, greedy with penalties and DRY, a greedy
    mirostat row, and one greedy row with every truncation stage set."""
    cfgs = [tsamp.SamplerConfig(greedy=True),
            tsamp.SamplerConfig(greedy=True, penalty_repeat=1.3, penalty_freq=0.2,
                                penalty_present=0.1, dry_multiplier=0.8),
            tsamp.SamplerConfig(greedy=True, mirostat_tau=5.0),
            tsamp.SamplerConfig(greedy=True, top_k=20, top_p=0.9, min_p=0.05, typical_p=0.95,
                                top_n_sigma=1.5)]
    return [cfgs[i % len(cfgs)] for i in range(B)]


def test_sample_batch_greedy_matches_jax():
    """The same greedy tokens as JAX's sample_batch for rows with penalties,
    DRY, mirostat and the truncation stages, over 6 steps that feed the
    penalty ring; the ring, its order and the counts match exactly."""
    B, V = 4, 300
    rng = np.random.default_rng(0)
    jp, tp = jsamp.BatchSamplerParams.neutral(B), tsamp.BatchSamplerParams.neutral(B)
    for i, c in enumerate(_sampler_rows(B)):
        jp = jp.with_row(i, jsamp.SamplerConfig(**vars(c)))
        tp = tp.with_row(i, c)
    for f in tsamp.BatchSamplerParams.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)))
    jpen, tpen = jsamp.PenaltyState.create(B, V, window=8), tsamp.PenaltyState.create(B, V, 8)
    jmu = jnp.full((B,), 10.0, jnp.float32)
    tmu = torch.full((B,), 10.0)
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    bias = np.zeros((B, V), np.float32)
    bias[0, 7] = 50.0
    for step in range(6):
        logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
        logits[:, :5] += 4.0  # a few strong tokens, so penalties and DRY matter
        jt, jmu = jax.jit(jsamp.sample_batch)(jnp.asarray(logits), jp, key, jpen.counts, jmu,
                                              dry_ctx=jpen.ordered(), bias=jnp.asarray(bias))
        tt, tmu = tsamp.sample_batch(torch.from_numpy(logits), tp, gen, tpen.counts, tmu,
                                     dry_ctx=tpen.ordered(), bias=torch.from_numpy(bias))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=1e-5)
        jpen = jpen.push(jt)
        tpen = tpen.push(tt)
        np.testing.assert_array_equal(tpen.ordered().numpy(), np.asarray(jpen.ordered()))
        np.testing.assert_array_equal(tpen.counts.numpy(), np.asarray(jpen.counts))
    jpen, tpen = jpen.clear_row(1), tpen.clear_row(1)
    np.testing.assert_array_equal(tpen.ordered().numpy(), np.asarray(jpen.ordered()))
    np.testing.assert_array_equal(tpen.counts.numpy(), np.asarray(jpen.counts))


def test_apply_dry_matches_jax():
    B, V, N = 3, 50, 24
    rng = np.random.default_rng(5)
    ring = rng.integers(0, 6, (B, N)).astype(np.int32)  # few ids: many repeats
    ring[2, :7] = -1
    ring[1, -6:] = ring[1, 4:10]  # a long repeat ending at the newest token
    logits = rng.standard_normal((B, V)).astype(np.float32)
    jp, tp = jsamp.BatchSamplerParams.neutral(B), tsamp.BatchSamplerParams.neutral(B)
    for i, (mult, base, allowed) in enumerate(((0.8, 1.75, 2), (1.5, 2.0, 1), (0.5, 1.5, 3))):
        c = dict(dry_multiplier=mult, dry_base=base, dry_allowed=allowed)
        jp = jp.with_row(i, jsamp.SamplerConfig(**c))
        tp = tp.with_row(i, tsamp.SamplerConfig(**c))
    want = np.asarray(jsamp.apply_dry(jnp.asarray(logits), jnp.asarray(ring), jp))
    got = tsamp.apply_dry(torch.from_numpy(logits), torch.from_numpy(ring), tp).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != logits).any()


def test_sample_batch_draws_follow_the_filters():
    """Non-greedy rows draw only among the candidates the chain keeps: with
    top_k 3 every draw is one of the 3 largest logits, and a banned token
    (bias -1e9) is never drawn."""
    B, V = 2, 100
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal((B, V)).astype(
        np.float32))
    p = tsamp.BatchSamplerParams.neutral(B)
    p = p.with_row(0, tsamp.SamplerConfig(temperature=0.8, top_k=3))
    p = p.with_row(1, tsamp.SamplerConfig(temperature=1.0))
    bias = torch.zeros((B, V))
    top1 = int(logits[1].argmax())
    bias[1, top1] = -1e9
    gen = torch.Generator().manual_seed(3)
    top3 = set(torch.topk(logits[0], 3).indices.tolist())
    seen = set()
    for _ in range(60):
        t = tsamp.sample_batch(logits, p, gen, bias=bias)
        assert int(t[0]) in top3 and int(t[1]) != top1
        seen.add(int(t[0]))
    assert len(seen) > 1


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_server") / "tiny_q4k.gguf")
    build_llama_gguf(path, vocab_size=512, n_embd=512, n_layer=2, n_head=4, n_head_kv=2,
                     n_ff=512, qtype=GGMLType.Q4_K, seed=11)
    jcfg, jparams, _ = jload(path)
    cfg, params, _ = load_model(path, device="cpu")
    return jcfg, jparams, cfg, params


BURST = [list(range(3, 13)), list(range(40, 52)), [9, 8, 7, 6, 5, 4, 3, 2]]
PAIR = [101, 7, 55, 3, 81, 200]


def _run_server(ctx, task_cls, params_cls, n_new=6):
    """A burst of three greedy requests on two slots (the third waits for a
    slot), then a sequential pair in slot 0 whose second prompt extends the
    first prompt and its completion. -> [(tokens, cached_tokens)]."""
    gp = lambda: params_cls(max_tokens=n_new, temperature=0.0)
    tasks = [task_cls(tokens=list(t), params=gp()) for t in BURST]
    for t in tasks:
        ctx.submit(t)
    ctx.start()
    try:
        out = []
        for t in tasks:
            done = [p for k, p in t.events() if k == "done"]
            assert done, "task failed"
            out.append((done[0]["tokens"], done[0]["stats"]["cached_tokens"]))
        first = ctx.generate(list(PAIR), gp())
        second = ctx.generate(PAIR + first["tokens"] + [42, 43], gp())
        out += [(r["tokens"], r["stats"]["cached_tokens"]) for r in (first, second)]
    finally:
        ctx.stop()
    return out


@pytest.mark.parametrize("kv", ["f32", "q8"])
def test_server_context_matches_jax(tiny, kv):
    """Identical greedy tokens and prefix reuse from the port's and the JAX
    package's ServerContext (f32 compute, 2 slots, decode chunks of 4,
    prefill chunks of 8 so the longer prompts take two)."""
    jcfg, jparams, cfg, params = tiny
    common = dict(n_slots=2, max_seq_len=64, decode_chunk=4, prefill_chunk=8)
    jctx = JServerContext(jcfg, jparams, None, compute_dtype=jnp.float32,
                          kv_dtype={"f32": jnp.float32, "q8": "q8"}[kv], **common)
    tctx = ServerContext(cfg, params, None, compute_dtype=torch.float32,
                         kv_dtype={"f32": torch.float32, "q8": "q8"}[kv], device="cpu",
                         **common)
    want = _run_server(jctx, JTask, JGenParams)
    got = _run_server(tctx, Task, GenParams)
    assert got == want
    assert all(len(toks) == 6 for toks, _ in got)
    assert got[-1][1] >= len(PAIR) and got[-2][1] == 0


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def http_server(tiny):
    _, _, cfg, params = tiny
    ctx = ServerContext(cfg, params, None, n_slots=2, max_seq_len=64, decode_chunk=4,
                        prefill_chunk=16, compute_dtype=torch.float32, kv_dtype="q8",
                        model_name="tiny", device="cpu")
    srv = serve(ctx, "127.0.0.1", _free_port(), block=False)
    yield ctx, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    ctx.stop()


def _post(url, path, body):
    req = urllib.request.Request(url + path, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read().decode()


def _status(url, path, body=None):
    try:
        if body is None:
            with urllib.request.urlopen(url + path, timeout=60) as r:
                return r.status, r.read().decode()
        return _post(url, path, body)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_http_health_models_props_slots(http_server):
    ctx, url = http_server
    assert json.loads(_status(url, "/health")[1])["status"] == "ok"
    assert json.loads(_status(url, "/v1/models")[1])["data"][0]["id"] == "tiny"
    props = json.loads(_status(url, "/props")[1])
    assert (props["n_ctx"], props["n_slots"], props["vocab_size"]) == (64, 2, 512)
    assert len(json.loads(_status(url, "/slots")[1])) == 2


def test_http_completion_plain_and_streamed(http_server):
    """The same greedy request plain and as SSE: the streamed deltas join
    to the plain text, and the text is the token ids (no tokenizer)."""
    ctx, url = http_server
    body = {"prompt": [5, 6, 7, 8, 9], "max_tokens": 7, "temperature": 0}
    code, text = _post(url, "/v1/completions", body)
    r = json.loads(text)
    assert code == 200 and r["usage"]["completion_tokens"] == 7
    choice = r["choices"][0]
    assert choice["text"] == " ".join(map(str, choice["tokens"]))
    assert choice["finish_reason"] == "length"
    code, raw = _post(url, "/v1/completions", dict(body, stream=True))
    assert code == 200
    events = [json.loads(line[6:]) for line in raw.splitlines()
              if line.startswith("data: ") and line != "data: [DONE]"]
    assert raw.rstrip().endswith("data: [DONE]")
    assert "".join(e["choices"][0]["text"] for e in events) == choice["text"]
    assert events[-1]["choices"][0]["finish_reason"] == "length"
    assert events[-1]["timings"]["completion_tokens"] == 7


def test_http_logprobs_and_metrics(http_server):
    ctx, url = http_server
    r = json.loads(_post(url, "/completions", {"prompt": [1, 2, 3], "max_tokens": 3,
                                              "temperature": 0, "n_probs": 2})[1])
    lp = r["choices"][0]["logprobs"]
    assert len(lp["token_logprobs"]) == 3 and all(len(t) == 2 for t in lp["top_logprobs"])
    assert all(x <= 0 for x in lp["token_logprobs"])
    code, text = _status(url, "/metrics")
    assert code == 200 and "tpullm:requests_total" in text
    assert "tpullm:generated_tokens_total" in text


@pytest.mark.parametrize("path,body,what", [
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}]}, "chat"),
    ("/completion", {"prompt": "hello"}, "tokenizer"),
    ("/tokenize", {"content": "hi"}, "tokenizer"),
    ("/v1/embeddings", {"input": [1, 2]}, "embeddings"),
    ("/slots/0?action=save", {"filename": "a"}, "slot"),
    ("/completion", {"prompt": [1, 2], "grammar": "root ::= \"a\""}, "grammar"),
    ("/completion", {"prompt": [1, 2], "json_schema": {"type": "object"}}, "json_schema"),
    ("/completion", {"prompt": [1, 2], "samplers": ["infill"]}, "infill"),
    ("/v1/responses", {"input": "x"}, "Responses"),
])
def test_http_not_ported_answers_501(http_server, path, body, what):
    ctx, url = http_server
    code, text = _status(url, path, body)
    assert code == 501 and what in json.loads(text)["error"]["message"], text


@pytest.mark.parametrize("kv", ["f32", "q8"])
def test_server_context_shift_long_generation(tiny, kv):
    """A generation that outgrows the 64-slot cache shifts its context
    (update_slots' context shift) and still returns every token asked for,
    each in the vocabulary; the JAX package's context does the same."""
    jcfg, jparams, cfg, params = tiny
    common = dict(n_slots=1, max_seq_len=64, decode_chunk=4, prefill_chunk=16)
    tctx = ServerContext(cfg, params, None, compute_dtype=torch.float32,
                         kv_dtype={"f32": torch.float32, "q8": "q8"}[kv], device="cpu", **common)
    jctx = JServerContext(jcfg, jparams, None, compute_dtype=jnp.float32,
                          kv_dtype={"f32": jnp.float32, "q8": "q8"}[kv], **common)
    out = {}
    for name, ctx, gp in (("port", tctx, GenParams), ("jax", jctx, JGenParams)):
        ctx.start()
        try:
            r = ctx.generate(list(range(1, 41)), gp(max_tokens=40, temperature=0.0))
        finally:
            ctx.stop()
        assert len(r["tokens"]) == 40 and all(0 <= t < 512 for t in r["tokens"])
        out[name] = (ctx.metrics.get("context_shifts_total", 0), r["stats"]["prompt_tokens"])
    assert out["port"] == out["jax"] and out["port"][0] >= 1
