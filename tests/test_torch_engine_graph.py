"""The batch engine's decode step, the function a CUDA graph captures on the
card, held on the CPU: the device-side slot against the int cache_pos
path (bit for bit), the step over whole and short chunks against the JAX
engine, the graph key and its bookkeeping over a run of generate calls, the
buffers reused across calls, the launch counts of a capture, and the
arrival counters refusing to be made during a capture. Card-only checks of
the graph itself are in tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGMLType
from tpullm.runtime.engine import InferenceEngine as JEngine
from tpullm.runtime.loader import load_model as jload
from tpullm.utils.synth import build_llama_gguf
from tpullm_torch.models.llama import KVCache, forward
from tpullm_torch.ops import _cuda, flash_decode, layer_kernel
from tpullm_torch.ops.sampling import GREEDY, SamplerConfig, make_sample_fn
from tpullm_torch.runtime.engine import InferenceEngine, decode_chunks, step_key
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

torch.set_num_threads(2)

PROMPTS = [[3, 9, 4, 17, 6], [5, 1, 2], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 2, 3, 4, 5, 6, 7,
                                          8, 9, 30]]
SAMPLED = SamplerConfig(temperature=0.8, top_k=40, top_p=0.9, min_p=0.02)


@pytest.fixture(scope="module")
def small():
    return synth_kmajor_q4k_fast(vocab_size=256, n_embd=512, n_layer=2, n_head=4, n_head_kv=2,
                                 n_ff=512, seed=4, centred=True, device="cpu")


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_engine_graph") / "llama_q4k.gguf")
    build_llama_gguf(path, vocab_size=512, n_embd=512, n_layer=2, n_head=4,
                     n_head_kv=2, n_ff=512, qtype=GGMLType.Q4_K, seed=11)
    return path


def _cache_tensors(cache):
    return [t for t in (cache.k, cache.v, cache.ks, cache.vs) if t is not None]


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.float32, "q8"], ids=["bf16", "f32", "q8"])
@pytest.mark.parametrize("slot,view", [(16, 64), (40, 64), (63, 64), (100, 128), (127, 128)])
def test_device_slot_matches_int_cache_pos(small, kv, slot, view):
    """A decode step with a (B,) slot tensor, every row at the same slot,
    gives the int cache_pos path's logits and cache bit for bit (bf16, f32
    and int8 caches), rows left-padded to different depths."""
    cfg, params = small
    dtype = torch.float32 if kv == torch.float32 else torch.bfloat16
    g = np.random.default_rng(slot)
    B, T = 3, 16
    toks = torch.from_numpy(g.integers(0, cfg.vocab_size, (B, T)))
    vf = torch.tensor([0, 5, 9])
    pos = (torch.arange(T)[None] - vf[:, None]).clamp_min(0)
    tok1 = torch.from_numpy(g.integers(0, cfg.vocab_size, (B, 1)))
    pos1 = torch.tensor([[slot], [slot - 5], [slot - 9]])
    out = []
    for cache_pos in (slot, torch.full((B,), slot, dtype=torch.int64)):
        cache = KVCache.create(cfg, B, 128, kv, "cpu")
        forward(params, cfg, toks, pos, cache, 0, vf, dtype)
        logits, _ = forward(params, cfg, tok1, pos1, cache, cache_pos, vf, dtype,
                            kv_view_len=view)
        out.append((logits, _cache_tensors(cache)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_decode_chunks_fill_the_cache():
    """Whole chunks, then power-of-two chunks up to the cache's last slot,
    each with the kv view the JAX engine picks."""
    assert decode_chunks(32, 33, 64, 20) == [(32, 20, 64), (52, 8, 64), (60, 4, 64)]
    assert decode_chunks(16, 5, 2048, 4) == [(16, 4, 512)]
    assert decode_chunks(508, 9, 2048, 4) == [(508, 4, 512), (512, 4, 1024)]
    assert decode_chunks(32, 1, 64, 20) == []


def test_step_over_chunks_matches_jax(gguf_path, monkeypatch):
    """The engine's step function run eagerly on the CPU over its static
    buffers: a whole chunk and two short ones that end at the cache's last
    slot (prompts bucketed to 32 slots of 64, chunks of 20, 8 and 4); every
    greedy token equals the JAX engine's on the same GGUF."""
    jcfg, jparams, _ = jload(gguf_path)
    cfg, params, _ = load_model(gguf_path, device="cpu")
    kw = dict(max_seq_len=64, decode_chunk=20)
    jr = JEngine(jcfg, jparams, compute_dtype=jnp.float32, **kw).generate(
        PROMPTS, max_new_tokens=64)
    eng = InferenceEngine(cfg, params, compute_dtype=torch.float32, device="cpu", **kw)
    steps = []
    step = eng._step
    monkeypatch.setattr(eng, "_step", lambda *a: (steps.append(a[2]), step(*a)))
    r = eng.generate(PROMPTS, max_new_tokens=64)
    assert len(steps) == 32 and all(len(t) == 33 for t in r.tokens)
    assert r.tokens == jr.tokens


@pytest.mark.parametrize("sampler", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_cuda_graphs_flag_leaves_cpu_results(small, sampler):
    """On the CPU cuda_graphs=True changes nothing: the same eager steps,
    the same tokens and logits, greedy or sampled at one seed; no graph."""
    cfg, params = small
    res = []
    for graphs in (True, False):
        eng = InferenceEngine(cfg, params, max_seq_len=128, compute_dtype=torch.float32,
                              decode_chunk=8, device="cpu", cuda_graphs=graphs)
        assert eng.cuda_graphs is False
        res.append(eng.generate(PROMPTS, max_new_tokens=20, sampler=sampler, seed=5,
                                return_logits=True))
        assert eng.graphs == {}
    assert res[0].tokens == res[1].tokens
    np.testing.assert_array_equal(res[0].logits, res[1].logits)


@pytest.mark.parametrize("kv", [torch.float32, "q8"], ids=["f32", "q8"])
def test_buffers_reused_across_calls_match_a_fresh_engine(small, kv):
    """The engine keeps one cache and one set of step buffers per batch
    size. A call after a deeper one (stale slots left in the cache) gives
    the tokens and logits of a fresh engine, bit for bit, and a new batch
    size gets its own buffers."""
    cfg, params = small
    mk = lambda: InferenceEngine(cfg, params, max_seq_len=128, compute_dtype=torch.float32,
                                 kv_dtype=kv, decode_chunk=8, device="cpu")
    eng = mk()
    g = np.random.default_rng(1)
    deep = [g.integers(0, cfg.vocab_size, n).tolist() for n in (60, 41, 33)]
    eng.generate(deep, max_new_tokens=40, sampler=SAMPLED, seed=2)
    st = eng.states[3]
    r = eng.generate(PROMPTS, max_new_tokens=17, return_logits=True)
    assert eng.states[3] is st
    fresh = mk().generate(PROMPTS, max_new_tokens=17, return_logits=True)
    assert r.tokens == fresh.tokens
    np.testing.assert_array_equal(r.logits, fresh.logits)
    eng.generate(PROMPTS[:2], max_new_tokens=3)
    assert sorted(eng.states) == [2, 3]


class _FakeGraph:
    """Stands in for a captured graph on the CPU: a replay runs the step."""

    def __init__(self, run):
        self.run = run

    def replay(self):
        self.run()


def test_step_key_over_generate_calls(small, monkeypatch):
    """The graph key (batch size, sampler, kv view, attention route) over a
    run of generate calls with varied batch sizes, prompt lengths, samplers
    and TPULLM_FLASH_DECODE. The engine's graph bookkeeping runs on the CPU
    with the capture replaced by an eager step and a graph whose replay
    runs the step: a key is captured at its first step and replayed after,
    the keys captured are the pure function's over decode_chunks, in order,
    and the tokens are the eager engine's."""
    cfg, params = small
    mk = lambda: InferenceEngine(cfg, params, max_seq_len=1024, compute_dtype=torch.float32,
                                 kv_dtype=torch.bfloat16, decode_chunk=4, device="cpu")
    eng, ref = mk(), mk()
    captured, replays = [], []

    def capture(key, st, sampler, kv_view):
        sample = make_sample_fn(sampler)
        eng._step(st, sample, kv_view)  # the warm-up: a real step
        captured.append(key)
        eng.graphs[key] = _FakeGraph(lambda: (replays.append(key),
                                              eng._step(st, sample, kv_view)))

    monkeypatch.setattr(eng, "_warm_up_and_capture", capture)
    eng.cuda_graphs = True
    g = np.random.default_rng(3)
    p = lambda *lens: [g.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    calls = [  # (prompts, max new tokens, sampler, flag)
        (p(5, 3, 19), 9, GREEDY, None),
        (p(7, 30, 2), 9, GREEDY, None),  # same key: T 32, view 512
        (p(9, 4), 9, GREEDY, None),  # B 2
        (p(3, 3, 3), 9, SAMPLED, None),  # another sampler
        (p(5, 3, 19), 9, GREEDY, "1"),  # kernel E's route: a key of its own
        (p(500, 3, 1), 13, GREEDY, "1"),  # T 512: views 1024 (E) and back to 1024
        (p(500, 3, 1), 13, GREEDY, None),
    ]
    want = []
    for prompts, n, sampler, flag in calls:
        if flag:
            monkeypatch.setenv("TPULLM_FLASH_DECODE", flag)
        else:
            monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
        T = 16
        while T < max(map(len, prompts)):
            T *= 2
        steps, new_keys = 0, 0
        for _, chunk, view in decode_chunks(T, n, 1024, 4):
            key = step_key(cfg, len(prompts), sampler, view, torch.bfloat16, True)
            if key not in want:
                want.append(key)
                new_keys += 1
            steps += chunk
        before = len(replays)
        r = eng.generate(prompts, max_new_tokens=n, sampler=sampler, seed=7)
        assert r.tokens == ref.generate(prompts, max_new_tokens=n, sampler=sampler,
                                        seed=7).tokens
        assert len(replays) - before == steps - new_keys
    assert captured == want
    routes = [k[3] for k in captured]
    assert routes == ["einsum", "einsum", "einsum", "flash_decode", "flash_decode", "einsum"]
    assert [k[0] for k in captured] == [3, 2, 3, 3, 3, 3]
    assert [k[2] for k in captured] == [512, 512, 512, 512, 1024, 1024]


def test_step_key_route_follows_the_built_shapes(small, monkeypatch):
    """The flag changes the key only where kernel E builds the step: a bf16
    or int8 cache at head dim 128, not an f32 cache; never off the card."""
    cfg, _ = small
    monkeypatch.setenv("TPULLM_FLASH_DECODE", "1")
    on = {dt: step_key(cfg, 4, GREEDY, 512, dt, True)[3]
          for dt in (torch.bfloat16, torch.int8, torch.float32)}
    assert on == {torch.bfloat16: "flash_decode", torch.int8: "flash_decode",
                  torch.float32: "einsum"}
    assert step_key(cfg, 4, GREEDY, 512, torch.bfloat16, False)[3] == "einsum"
    monkeypatch.delenv("TPULLM_FLASH_DECODE")
    assert step_key(cfg, 4, GREEDY, 512, torch.bfloat16, True)[3] == "einsum"
    assert step_key(cfg, 4, GREEDY, 512, torch.bfloat16, True) != step_key(
        cfg, 4, SAMPLED, 512, torch.bfloat16, True)


def test_capture_counts_are_taken_back_and_added_per_replay():
    """A capture launches nothing: what the wrappers counted during it is
    taken back and recorded; each replay adds it again."""
    _cuda.reset_counts()
    _cuda.COUNTS["qmm"] = 2
    delta = {}
    with _cuda.counts_taken_back(delta):
        _cuda.COUNTS["qmm_splitk"] += 3
        _cuda.COUNTS["layer_kernel"] += 2
    assert delta["qmm_splitk"] == 3 and delta["layer_kernel"] == 2 and delta["qmm"] == 0
    assert _cuda.COUNTS["qmm_splitk"] == 0 and _cuda.COUNTS["qmm"] == 2
    for _ in range(4):
        _cuda.add_counts(delta)
    assert _cuda.COUNTS["qmm_splitk"] == 12 and _cuda.COUNTS["layer_kernel"] == 8
    with pytest.raises(ValueError), _cuda.counts_taken_back(delta):
        _cuda.COUNTS["flash_decode"] += 1
        raise ValueError("a failed capture")
    assert _cuda.COUNTS["flash_decode"] == 0 and delta["flash_decode"] == 1
    _cuda.reset_counts()


@pytest.mark.parametrize("which", ["layer_kernel", "flash_decode", "flash_decode_reserve"])
def test_counters_refuse_to_be_made_during_capture(monkeypatch, which):
    """Kernel D's and E's arrival counters are made by an eager launch (a
    device's shared buffer, or an owner's own_counters), never inside a
    graph capture: a buffer first made there would belong to the graph's
    pool while eager launches share it."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        if which == "layer_kernel":
            layer_kernel._counters(97)
        elif which == "flash_decode":
            flash_decode._counters(torch.device("cuda", 97), 16)
        else:
            _cuda.own_counters(torch.device("cuda", 97), 4, 8, 1024)
    assert 97 not in flash_decode._COUNTERS
