"""The iSWA dual cache in the port (llama_kv_cache_iswa: the SWA layers keep
a ring of window + chunk slots, position p at slot p % ring), held against
the JAX package on the CPU, as tests/test_iswa.py holds the JAX package's
ring against its own full cache. On the synth gemma2 (2 layers, layer 0
SWA) and gemma3 (6 layers, layers 0-4 SWA) with the window of 32, at Q4_K
K-major widths: the cache's banks and ring; the port's iSWA engine against
the JAX one (f32 logits, greedy tokens past the window with the ring
wrapped) and against the port's full cache; the server's ring against its
full cache, prefix reuse and reprocessing, and a context shift that
reprocesses, each against a JAX ServerContext with iswa=True; the ring mask
of the plain attention paths against JAX ``attention(..., ring=...)``; and
the store with wrap against the cache JAX's forward leaves.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_iswa.py -q
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGMLType
from tpullm.models.config import ModelConfig as JConfig
from tpullm.models.llama import KVCache as JKVCache
from tpullm.models.llama import attention as jattention
from tpullm.models.llama import forward as jforward
from tpullm.runtime.engine import InferenceEngine as JEngine
from tpullm.runtime.loader import load_model as jload
from tpullm.server.context import GenParams as JGenParams
from tpullm.server.context import ServerContext as JServerContext
from tpullm.server.context import Task as JTask
from tpullm.utils.synth import build_arch_gguf
from tpullm_torch.models.config import ModelConfig
from tpullm_torch.models.llama import KVCache, bank_map, forward, swa_flags
from tpullm_torch.ops.flash_attention import masked_attention
from tpullm_torch.ops.flash_decode import flash_decode_plain
from tpullm_torch.ops.kv_store import kv_store_plain
from tpullm_torch.runtime.engine import InferenceEngine
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.server.context import GenParams, ServerContext, Task
from tpullm_torch.utils.from_jax import kv_cache_from_numpy

torch.set_num_threads(2)

WINDOW = 32  # build_arch_gguf's sliding window for a row with swa_pattern > 1
CHUNK = 32  # prefill_chunk: the ring holds WINDOW + CHUNK = 64 slots
DEPTH = {"gemma2": 2, "gemma3": 6}
_rng = np.random.default_rng(23)
# past the window; the 70-token prompt wraps the 64-slot ring in its prefill
PROMPTS = [_rng.integers(1, 256, n).tolist() for n in (70, 45)]


def _nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / max((b ** 2).mean(), 1e-30))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{arch: (port cfg, port params, JAX cfg, JAX params)} at K-major
    widths (head dim 128), Q4_K, from one GGUF each."""
    out = {}
    d = tmp_path_factory.mktemp("iswa")
    for arch, n_layer in DEPTH.items():
        path = str(d / f"{arch}.gguf")
        build_arch_gguf(path, arch, n_embd=512, n_layer=n_layer, n_head=4, n_head_kv=2,
                        n_ff=512, qtype=GGMLType.Q4_K, seed=11)
        jcfg, jparams, _ = jload(path)
        cfg, params, _ = load_model(path, device="cpu")
        assert cfg.sliding_window == WINDOW and any(swa_flags(cfg))
        out[arch] = (cfg, params, jcfg, jparams)
    return out


def _shapes(c):
    return {n: tuple(getattr(c, n).shape) for n in ("k", "v", "kw", "vw")
            if getattr(c, n) is not None}


@pytest.mark.parametrize("arch", sorted(DEPTH))
@pytest.mark.parametrize("S,chunk", [(512, 64), (256, CHUNK), (48, 64), (256, 0)])
def test_dual_cache_banks_match_jax(models, arch, S, chunk):
    """KVCache.create(..., iswa=True, max_chunk) gives the JAX package's
    banks and ring (min(window + max(chunk, 1), S), capped at the context),
    smaller than the full cache where the ring is; the int8 cache stays
    single; bank_map indexes the SWA layers into the ring banks in layer
    order."""
    cfg, _, jcfg, _ = models[arch]
    dual = KVCache.create(cfg, 2, S, torch.bfloat16, "cpu", iswa=True, max_chunk=chunk)
    jdual = JKVCache.create(jcfg, 2, S, jnp.bfloat16, iswa=True, max_chunk=chunk)
    assert dual.dual and jdual.dual
    assert _shapes(dual) == {n: tuple(getattr(jdual, n).shape) for n in ("k", "v", "kw", "vw")}
    assert dual.ring == jdual.ring == min(WINDOW + max(chunk, 1), S)
    assert dual.max_len == S
    single = KVCache.create(cfg, 2, S, torch.bfloat16, "cpu")
    assert not single.dual
    assert dual.nbytes < single.nbytes if dual.ring < S else dual.nbytes == single.nbytes
    for dt, jdt in (("q8", "q8"), (torch.float32, jnp.float32)):
        got = KVCache.create(cfg, 2, S, dt, "cpu", iswa=dt != "q8", max_chunk=chunk)
        want = JKVCache.create(jcfg, 2, S, jdt, iswa=dt != "q8", max_chunk=chunk)
        assert got.dual == want.dual == (dt != "q8")
        assert _shapes(got) == {n: tuple(getattr(want, n).shape) for n in ("k", "v", "kw", "vw")
                                if getattr(want, n) is not None}
    flags = swa_flags(cfg)
    banks = bank_map(cfg, True)
    assert [r for r, _ in banks] == flags
    assert [i for r, i in banks if r] == list(range(sum(flags)))
    assert [i for r, i in banks if not r] == list(range(len(flags) - sum(flags)))
    assert bank_map(cfg, False) == [(False, li) for li in range(cfg.n_layer)]


def _engine(cfg, params, iswa, max_seq_len=256, decode_chunk=8):
    return InferenceEngine(cfg, params, max_seq_len=max_seq_len, compute_dtype=torch.float32,
                           decode_chunk=decode_chunk, iswa=iswa, prefill_chunk=CHUNK,
                           device="cpu")


@pytest.mark.parametrize("arch", sorted(DEPTH))
def test_iswa_engine_matches_jax(models, arch):
    """The port's iSWA engine against the JAX iSWA engine, f32: the
    first-step logits of prompts of 70 and 45 tokens (prefilled in chunks
    of 32, the ring of 64 wrapped) at NMSE < 1e-10, and the same greedy
    tokens 24 steps past the window."""
    cfg, params, jcfg, jparams = models[arch]
    eng = _engine(cfg, params, True)
    assert eng.iswa
    r = eng.generate(PROMPTS, max_new_tokens=24, return_logits=True)
    assert eng.states[2].cache.dual and eng.states[2].cache.ring == WINDOW + CHUNK
    jeng = JEngine(jcfg, jparams, max_seq_len=256, compute_dtype=jnp.float32,
                   decode_chunk=8, iswa=True, prefill_chunk=CHUNK)
    jr = jeng.generate(PROMPTS, max_new_tokens=24, return_logits=True)
    assert _nmse(r.logits, jr.logits) < 1e-10
    assert r.tokens == jr.tokens and len(r.tokens[0]) == 24


@pytest.mark.parametrize("arch", sorted(DEPTH))
def test_iswa_engine_matches_full_cache(models, arch):
    """The port's ring against the port's full cache: the same greedy
    tokens, logits at NMSE < 1e-10 (generate's first step and logits_for's
    chunked prefill); the int8 cache keeps the full cache with iswa on,
    as the JAX engine does."""
    cfg, params, _, _ = models[arch]
    ring, full = _engine(cfg, params, True), _engine(cfg, params, False)
    rr = ring.generate(PROMPTS, max_new_tokens=24, return_logits=True)
    rf = full.generate(PROMPTS, max_new_tokens=24, return_logits=True)
    assert _nmse(rr.logits, rf.logits) < 1e-10
    assert rr.tokens == rf.tokens
    assert _nmse(ring.logits_for([PROMPTS[0]]), full.logits_for([PROMPTS[0]])) < 1e-10
    q8 = InferenceEngine(cfg, params, max_seq_len=256, compute_dtype=torch.float32,
                         kv_dtype="q8", iswa=True, device="cpu")
    assert not q8.iswa and not q8.new_cache(1).dual


def _serve_greedy(make, task_cls, params_cls, prompts, n_new=12):
    """Greedy requests on a 2-slot server, all submitted at once."""
    ctx = make()
    ctx.start()
    try:
        tasks = [task_cls(tokens=list(p), params=params_cls(
            max_tokens=n_new, temperature=0.0, ignore_eos=True)) for p in prompts]
        for t in tasks:
            ctx.submit(t)
        outs = []
        for t in tasks:
            done = [p for k, p in t.events() if k == "done"]
            assert done, "task errored"
            outs.append(done[0]["tokens"])
        return outs, ctx
    finally:
        ctx.stop()


def _port_ctx(cfg, params, iswa, max_seq_len=256, n_slots=2):
    return lambda: ServerContext(cfg, params, None, n_slots=n_slots, max_seq_len=max_seq_len,
                                 decode_chunk=4, prefill_chunk=CHUNK,
                                 compute_dtype=torch.float32, iswa=iswa, device="cpu")


def _jax_ctx(jcfg, jparams, iswa, max_seq_len=256, n_slots=2):
    return lambda: JServerContext(jcfg, jparams, None, n_slots=n_slots,
                                  max_seq_len=max_seq_len, decode_chunk=4,
                                  prefill_chunk=CHUNK, compute_dtype=jnp.float32, iswa=iswa)


@pytest.mark.parametrize("arch", sorted(DEPTH))
def test_server_ring_matches_full_and_jax(models, arch):
    """Server slots on the dual cache: the same greedy tokens as the port's
    full-context slots and as a JAX ServerContext with iswa=True, with the
    SWA layers' KV ring-sized."""
    cfg, params, jcfg, jparams = models[arch]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 250, 60).tolist(), rng.integers(1, 250, 9).tolist()]
    dual, ctx_d = _serve_greedy(_port_ctx(cfg, params, True), Task, GenParams, prompts)
    full, ctx_f = _serve_greedy(_port_ctx(cfg, params, False), Task, GenParams, prompts)
    want, _ = _serve_greedy(_jax_ctx(jcfg, jparams, True), JTask, JGenParams, prompts)
    assert dual == full == want
    assert ctx_d.memory.cache.dual and not ctx_f.memory.cache.dual
    assert ctx_d.memory.cache.nbytes < ctx_f.memory.cache.nbytes


def _reuse_run(make, task_cls, params_cls, base):
    """Back-to-back requests on one slot sharing a prefix: the second
    reuses it, the third truncates it. -> [(tokens, cached_tokens)]."""
    ctx = make()
    ctx.start()
    try:
        outs = []
        for tail in ([7, 3], [7, 3], [11]):
            t = task_cls(tokens=base + tail, params=params_cls(
                max_tokens=8, temperature=0.0, ignore_eos=True))
            ctx.submit(t)
            done = [p for k, p in t.events() if k == "done"][0]
            outs.append((done["tokens"], done["stats"]["cached_tokens"]))
        return outs
    finally:
        ctx.stop()


@pytest.mark.parametrize("arch", sorted(DEPTH))
@pytest.mark.parametrize("n_base", [50, 20])
def test_server_prefix_reuse_and_reprocess(models, arch, n_base):
    """Prefix reuse on the ring, and its refusal once the ring no longer
    holds the window (the whole prompt reprocessed): the port's tokens and
    cached-token counts equal the JAX iSWA server's, and the reused run
    equals the fresh one."""
    cfg, params, jcfg, jparams = models[arch]
    base = np.random.default_rng(5).integers(1, 250, n_base).tolist()
    got = _reuse_run(_port_ctx(cfg, params, True, n_slots=1), Task, GenParams, base)
    want = _reuse_run(_jax_ctx(jcfg, jparams, True, n_slots=1), JTask, JGenParams, base)
    assert got == want
    assert got[0][0] == got[1][0]
    assert got[1][1] > 0 or got[1][1] == want[1][1]


@pytest.mark.parametrize("arch", sorted(DEPTH))
def test_server_context_shift_reprocesses(models, arch):
    """A slot that overflows a 64-slot context on the dual cache is
    reprocessed from its kept tokens (the ring cannot shift) and goes on
    generating: the same 40 tokens as the JAX iSWA server; the memory's
    context_shift refuses the dual cache."""
    cfg, params, jcfg, jparams = models[arch]
    prompts = [np.random.default_rng(8).integers(1, 250, 40).tolist()]
    got, ctx = _serve_greedy(_port_ctx(cfg, params, True, max_seq_len=64), Task, GenParams,
                             prompts, n_new=40)
    want, jctx = _serve_greedy(_jax_ctx(jcfg, jparams, True, max_seq_len=64), JTask,
                               JGenParams, prompts, n_new=40)
    assert got == want and len(got[0]) == 40
    assert ctx.metrics.get("context_shifts_total", 0) >= 1
    assert ctx.metrics["context_shifts_total"] == jctx.metrics["context_shifts_total"]
    with pytest.raises(RuntimeError, match="iSWA"):
        ctx.memory.slots[0].n_past = 10
        ctx.memory.context_shift(0, 2, 4)


# (B, T, first query slots, valid_from, window): decode steps and prefill
# chunks over a ring of 48 = window 32 + chunk 16, some rows past a wrap
RING_CASES = [
    (4, 1, (100, 47, 20, 5), (0, 0, 3, 0), 32),
    (4, 4, (100, 44, 20, 2), (0, 7, 3, 0), 32),
    (2, 8, (200, 33), (0, 30), 32),
    (2, 16, (80, 16), (0, 5), 32),
    (1, 16, (64,), (0,), 40),
]


def _ring_inputs(B, T, first, vf, D=128, H=4, Hkv=2, ring=48, seed=0):
    r = np.random.default_rng(seed)
    q = (r.standard_normal((B, T, H, D)) * 0.5).astype(np.float32)
    k = (r.standard_normal((B, Hkv, ring, D)) * 0.5).astype(np.float32)
    v = (r.standard_normal((B, Hkv, ring, D)) * 0.5).astype(np.float32)
    qs = np.asarray(first, np.int32)[:, None] + np.arange(T, dtype=np.int32)[None]
    vf = np.asarray(vf, np.int32)
    return q, k, v, qs, qs - vf[:, None], vf


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("B,T,first,vf,window", RING_CASES)
def test_ring_mask_plain_paths_match_jax(B, T, first, vf, window, softcap):
    """masked_attention and flash_decode_plain (T <= 8) with ``ring``
    against JAX attention(..., ring=48) on the CPU (its einsum path): f32 at
    NMSE < 1e-10, and E's plain version (bf16 K/V, p rounded to bf16) at <
    1e-4 on every row."""
    ring = 48
    q, k, v, qs, pos, vfa = _ring_inputs(B, T, first, vf, ring=ring)
    kw = dict(n_head=4, n_head_kv=2, head_dim=128, head_dim_v=128, n_embd=512,
              attn_logit_softcap=softcap, sliding_window=window)
    ji = lambda a: jnp.asarray(a, jnp.int32)
    kvp = np.zeros((B, ring), np.int32)  # not read on a ring
    want = np.asarray(jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), ji(qs),
                                 ji(kvp), ji(pos), ji(vfa), JConfig(**kw), True,
                                 ring=ring), np.float32)
    tl = lambda a: torch.from_numpy(np.array(a, np.int64))
    tf = lambda a: torch.from_numpy(a)
    scale = 128 ** -0.5
    got = masked_attention(tf(q), tf(k), tf(v), tl(qs), tl(kvp), tl(pos), tl(vfa), scale,
                           softcap, window, ring).numpy()
    assert _nmse(got, want) < 1e-10
    if T <= 8:
        bf = lambda a: tf(a).to(torch.bfloat16)
        got_e = flash_decode_plain(bf(q), bf(k), bf(v), tl(qs), tl(pos), tl(vfa), scale,
                                   softcap, window, ring=ring).float().numpy()
        ref = masked_attention(bf(q).float(), bf(k).float(), bf(v).float(), tl(qs), tl(kvp),
                               tl(pos), tl(vfa), scale, softcap, window, ring).numpy()
        for b in range(B):
            assert _nmse(got_e[b], ref[b]) < 1e-4, b


@pytest.mark.parametrize("arch", sorted(DEPTH))
def test_kv_store_wrap_matches_jax_cache(models, arch):
    """The store with wrap against the f32 dual cache JAX's forward leaves:
    two prompt chunks of 32 (positions 0-63) fill the ring of window + 32 =
    64 slots, then a chunk of 32 at positions 64-95 wraps it. The cache after
    the first two chunks comes across (kv_cache_from_numpy);
    kv_store_plain of the third chunk's rows (read from JAX's final ring)
    with ring=64 gives JAX's final ring bit for bit, and the port's forward
    of the third chunk from the carried cache gives JAX's final cache at
    NMSE < 1e-10 (f32 compute and cache)."""
    cfg, params, jcfg, jparams = models[arch]
    toks = np.random.default_rng(9).integers(1, 250, (1, 96)).astype(np.int32)
    pos = np.arange(96, dtype=np.int32)[None]
    jc = JKVCache.create(jcfg, 1, 128, jnp.float32, iswa=True, max_chunk=CHUNK)
    vf = jnp.zeros((1,), jnp.int32)
    for lo, hi in ((0, 32), (32, 64)):
        _, jc = jforward(jparams, jcfg, jnp.asarray(toks[:, lo:hi]), jnp.asarray(pos[:, lo:hi]),
                         jc, lo, vf, dtype=jnp.float32)
    carried = kv_cache_from_numpy(*(np.asarray(a) for a in (jc.k, jc.v)), device="cpu",
                                  kw=np.asarray(jc.kw), vw=np.asarray(jc.vw), ring=jc.ring)
    _, jc2 = jforward(jparams, jcfg, jnp.asarray(toks[:, 64:96]), jnp.asarray(pos[:, 64:96]),
                      jc, 64, vf, dtype=jnp.float32)
    final = kv_cache_from_numpy(*(np.asarray(a) for a in (jc2.k, jc2.v)), device="cpu",
                                kw=np.asarray(jc2.kw), vw=np.asarray(jc2.vw), ring=jc2.ring)
    ring = carried.ring
    assert ring == WINDOW + CHUNK and carried.dual
    slots = torch.arange(64, 96) % ring
    first = torch.tensor([64])
    for li in range(carried.kw.shape[0]):
        kb, vb = carried.kw[li].clone(), carried.vw[li].clone()
        k_rows = final.kw[li][:, :, slots].transpose(1, 2)  # (B, T, Hkv, D)
        v_rows = final.vw[li][:, :, slots].transpose(1, 2)
        kv_store_plain(kb, vb, k_rows, v_rows, first, ring=ring)
        assert torch.equal(kb, final.kw[li]) and torch.equal(vb, final.vw[li])
    assert not torch.equal(carried.kw, final.kw)  # the chunk moved the ring
    port = kv_cache_from_numpy(*(np.asarray(a) for a in (jc.k, jc.v)), device="cpu",
                               kw=np.asarray(jc.kw), vw=np.asarray(jc.vw), ring=jc.ring)
    forward(params, cfg, torch.from_numpy(toks[:, 64:96].astype(np.int64)),
            torch.from_numpy(pos[:, 64:96].astype(np.int64)), port, 64,
            torch.zeros((1,), dtype=torch.int64), torch.float32)
    for name in ("k", "v", "kw", "vw"):
        assert _nmse(getattr(port, name), getattr(final, name)) < 1e-10, name


def test_flash_decode_refuses_other_rings():
    """Kernel E's wrapper takes a ring only as the dual cache makes one:
    bf16/f32 K/V (the int8 cache has no ring), no chunked window, and a
    ring equal to the bank's slots; anything else raises, on the CPU too."""
    from tpullm_torch.ops.flash_decode import flash_decode

    cfg = ModelConfig(n_head=4, n_head_kv=2, head_dim=128, head_dim_v=128, sliding_window=32)
    q, k, v, qs, pos, vf = (torch.from_numpy(np.array(a)) for a in _ring_inputs(
        2, 1, (100, 47), (0, 0)))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    qs, pos, vf = qs.long(), pos.long(), vf.long()
    ks = torch.ones(k.shape[:3])
    with pytest.raises(ValueError, match="int8"):
        flash_decode(q, k.to(torch.int8), v.to(torch.int8), qs, pos, vf, cfg, 32,
                     k_scales=ks, v_scales=ks, ring=48)
    with pytest.raises(ValueError, match="chunked"):
        flash_decode(q, k, v, qs, pos, vf, dataclasses.replace(cfg, swa_chunked=True), 32,
                     ring=48)
    with pytest.raises(ValueError, match="ring of 64 over 48"):
        flash_decode(q, k, v, qs, pos, vf, cfg, 32, ring=64)
    assert flash_decode(q, k, v, qs, pos, vf, cfg, 32, ring=48).shape == (2, 1, 4, 128)
