"""The gemma family (gemma, gemma2, gemma3) and the granite/minicpm scale
keys in the port, held against the JAX package on the CPU: the config keys
parsed as the JAX parser parses them; gemma2 and gemma3 at Q4_K K-major
widths through both engines and both servers (bf16 and q8 caches) with
prompts longer than the synth's window of 32, SWA layers at their own rope
base; the server CLI's ring default; kernel C's plain version at head dim
256 against the Pallas kernel in interpret mode; the Gemma synth; and each
place where the JAX package departs from llama.cpp, pinned as the JAX
package computes it.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_gemma.py -q
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGMLType
from tpullm.gguf.reader import GGUFFile as JGGUFFile
from tpullm.gguf.writer import GGUFWriter
from tpullm.models.config import ModelConfig as JConfig
from tpullm.models.config import config_from_gguf as jconfig_from_gguf
from tpullm.models.llama import swa_flags as jswa_flags
from tpullm.ops.flash_attention import flash_attention as jflash
from tpullm.runtime.engine import InferenceEngine as JEngine
from tpullm.runtime.loader import load_model as jload
from tpullm.server.context import GenParams as JGenParams
from tpullm.server.context import ServerContext as JServerContext
from tpullm.server.context import Task as JTask
from tpullm.utils.synth import build_arch_gguf
from tpullm_torch.gguf.reader import GGUFFile
from tpullm_torch.models.config import ModelConfig, config_from_gguf
from tpullm_torch.models.llama import KVCache, forward, layer_windows, swa_flags
from tpullm_torch.ops.flash_attention import attention_params, flash_attention
from tpullm_torch.runtime.engine import InferenceEngine
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.server.context import GenParams, ServerContext, Task

torch.set_num_threads(2)

WINDOW = 32  # build_arch_gguf's sliding window for a row with swa_pattern > 1
SWA_BASE = 1000.0  # rope_base_swa set on both configs (the file's base is 1e4)
_rng = np.random.default_rng(17)
# prompts past the window, so it bites in prefill and in every decode step
PROMPTS = [_rng.integers(1, 256, n).tolist() for n in (45, 38, 60)]
DEPTH = {"gemma2": 2, "gemma3": 6}  # gemma3: layers 0-4 SWA, layer 5 full


def _nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / max((b ** 2).mean(), 1e-30))


def _fields(c):
    return {k: v for k, v in dataclasses.asdict(c).items() if k != "raw_kv"}


@pytest.fixture(scope="module")
def gemma_models(tmp_path_factory):
    """{arch: (port cfg, port params, JAX cfg, JAX params)}: gemma2 and
    gemma3 at K-major widths (head dim 128), Q4_K, with rope_base_swa set on
    both configs."""
    out = {}
    d = tmp_path_factory.mktemp("gemma")
    for arch, n_layer in DEPTH.items():
        path = str(d / f"{arch}.gguf")
        build_arch_gguf(path, arch, n_embd=512, n_layer=n_layer, n_head=4, n_head_kv=2,
                        n_ff=512, qtype=GGMLType.Q4_K, seed=11)
        jcfg, jparams, _ = jload(path)
        cfg, params, _ = load_model(path, device="cpu")
        assert _fields(cfg) == _fields(jcfg)
        assert cfg.sliding_window == WINDOW
        out[arch] = (dataclasses.replace(cfg, rope_base_swa=SWA_BASE), params,
                     dataclasses.replace(jcfg, rope_base_swa=SWA_BASE), jparams)
    return out


@pytest.mark.parametrize("arch", sorted(DEPTH))
def test_gemma_engine_matches_jax(gemma_models, arch):
    """Greedy tokens identical and logits at NMSE < 1e-6 from the port's and
    the JAX package's engine (plain f32 path on both sides), prompts longer
    than the window, the SWA layers roped at rope_base_swa; the window and
    the SWA base each move the logits."""
    cfg, params, jcfg, jparams = gemma_models[arch]
    assert swa_flags(cfg) == jswa_flags(jcfg)
    run = lambda c: InferenceEngine(c, params, max_seq_len=128, compute_dtype=torch.float32,
                                    decode_chunk=4, device="cpu").generate(
        PROMPTS, max_new_tokens=8, return_logits=True)
    jr = JEngine(jcfg, jparams, max_seq_len=128, compute_dtype=jnp.float32,
                 decode_chunk=4).generate(PROMPTS, max_new_tokens=8, return_logits=True)
    r = run(cfg)
    assert _nmse(r.logits, jr.logits) < 1e-6
    assert r.tokens == jr.tokens
    for other in (dict(sliding_window=0), dict(rope_base_swa=0.0)):
        assert _nmse(run(dataclasses.replace(cfg, **other)).logits, r.logits) > 1e-8, other


def _serve(ctx, task_cls, params_cls, n_new=6):
    """Three greedy requests past the window on two slots (the third waits),
    then a sequential pair whose second prompt extends the first's prompt
    and completion. -> [(tokens, cached_tokens)]."""
    gp = lambda: params_cls(max_tokens=n_new, temperature=0.0)
    tasks = [task_cls(tokens=list(t), params=gp()) for t in PROMPTS]
    for t in tasks:
        ctx.submit(t)
    ctx.start()
    try:
        out = []
        for t in tasks:
            done = [p for k, p in t.events() if k == "done"]
            assert done, "task failed"
            out.append((done[0]["tokens"], done[0]["stats"]["cached_tokens"]))
        first = ctx.generate(PROMPTS[1][:36], gp())
        second = ctx.generate(PROMPTS[1][:36] + first["tokens"] + [42, 43], gp())
        out += [(r["tokens"], r["stats"]["cached_tokens"]) for r in (first, second)]
    finally:
        ctx.stop()
    return out


@pytest.mark.parametrize("kv", ["bf16", "q8"])
@pytest.mark.parametrize("arch", sorted(DEPTH))
def test_gemma_server_context_matches_jax(gemma_models, arch, kv):
    """Identical greedy tokens and prefix reuse from a port ServerContext
    and a JAX one (f32 compute, a bf16 or int8 cache, 2 slots, prefill
    chunks of 16 so every prompt takes several, decode chunks of 4)."""
    cfg, params, jcfg, jparams = gemma_models[arch]
    common = dict(n_slots=2, max_seq_len=128, decode_chunk=4, prefill_chunk=16)
    jctx = JServerContext(jcfg, jparams, None, compute_dtype=jnp.float32,
                          kv_dtype={"bf16": jnp.bfloat16, "q8": "q8"}[kv], **common)
    tctx = ServerContext(cfg, params, None, compute_dtype=torch.float32,
                         kv_dtype={"bf16": torch.bfloat16, "q8": "q8"}[kv], device="cpu",
                         **common)
    want = _serve(jctx, JTask, JGenParams)
    got = _serve(tctx, Task, GenParams)
    assert got == want
    assert got[-1][1] >= 36 and got[-2][1] == 0


def test_swa_full_refusal(gemma_models, tmp_path, monkeypatch):
    """The server CLI serves a model with sliding-window layers on the iSWA
    ring by default, as the JAX CLI does (iswa = not --swa-full): a bf16
    cache gets the dual cache (ring = window + --prefill-chunk), --swa-full
    the full-context cache, and --kv-type q8 the full-context int8 cache
    (the ring is bf16/f32 only), which the CLI once refused. The loader
    returns the CPU model and the context is built on the CPU; serve is
    stubbed, so nothing goes to a card and no port is bound."""
    import tpullm_torch.runtime.loader as loader
    import tpullm_torch.server.context as context
    import tpullm_torch.server.http as http
    from tpullm_torch.server.__main__ import main

    cfg, params, _, _ = gemma_models["gemma2"]
    loaded, served = [], []

    def load_stub(path, device):
        loaded.append((path, device))
        return cfg, params, {}

    class CpuContext(context.ServerContext):
        def __init__(self, *a, **kw):
            super().__init__(*a, **dict(kw, device="cpu"))

    monkeypatch.setattr(loader, "load_model", load_stub)
    monkeypatch.setattr(context, "ServerContext", CpuContext)
    monkeypatch.setattr(http, "serve", lambda ctx, host, port: served.append(ctx))
    path = str(tmp_path / "g2.gguf")
    base = ["-m", path, "-c", "256", "-np", "2", "--prefill-chunk", "64"]
    for extra, dual in (([], True), (["--swa-full"], False), (["--kv-type", "q8"], False),
                        (["--kv-type", "f32"], True)):
        main(base + extra)
        cache = served[-1].memory.cache
        assert cache.dual == dual, extra
        assert cache.quantized == ("q8" in extra)
        if dual:
            assert cache.ring == cfg.sliding_window + 64
            assert cache.kw.shape[0] == sum(swa_flags(cfg))
            assert cache.k.shape[0] == cfg.n_layer - sum(swa_flags(cfg))
        else:
            assert cache.k.shape[0] == cfg.n_layer
    assert loaded == [(path, "cuda")] * 4
    assert ServerContext(cfg, params, iswa=True, device="cpu").memory.cache.dual


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (50.0, 0), (0.0, 40), (50.0, 100)])
@pytest.mark.parametrize("heads", [(4, 2), (4, 4)], ids=["G2", "G1"])
@pytest.mark.parametrize("n_past,kv_len", [(0, 256), (256, 512)], ids=["slot0", "slot256"])
def test_flash_plain_vs_pallas_head_dim_256(softcap, window, heads, n_past, kv_len):
    """Kernel C's plain version at Dk = Dv = 256 against the Pallas kernel in
    interpret mode, bf16 q/k/v, with Gemma-2's softcap of 50 and windows
    that bite: NMSE < 2e-4 on every row with a visible key (the bar of
    tests/test_torch_attention.py's 128 cases)."""
    H, HKV = heads
    B, T, D, S = 2, 128, 256, kv_len
    r = np.random.default_rng(4)
    q, k, v = ((r.standard_normal(s) * 0.5).astype(np.float32)
               for s in ((B, T, H, D), (B, HKV, S, D), (B, HKV, S, D)))
    vf = np.asarray((0, 37), np.int32)
    qs = np.broadcast_to(n_past + np.arange(T, dtype=np.int32)[None], (B, T)).copy()
    pos = qs - vf[:, None]
    kvp = np.arange(S, dtype=np.int32)[None] - vf[:, None]
    kw = dict(n_head=H, n_head_kv=HKV, head_dim=D, head_dim_v=D, n_embd=H * D,
              attn_logit_softcap=softcap, sliding_window=window)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    ji = lambda a: jnp.asarray(a, jnp.int32)
    want = np.asarray(jflash(jb(q), jb(k), jb(v), ji(qs), ji(kvp), ji(pos), ji(vf),
                             JConfig(**kw), bool(window), interpret=True), np.float32)
    tb = lambda a: torch.from_numpy(np.array(jb(a).astype(jnp.float32))).to(torch.bfloat16)
    tl = lambda a: torch.from_numpy(np.array(a, np.int64))
    got = flash_attention(tb(q), tb(k), tb(v), tl(qs), tl(kvp), tl(pos), tl(vf),
                          ModelConfig(**kw), bool(window)).float().numpy()
    for b, f in enumerate((0, 37)):
        live = qs[b] >= f
        assert _nmse(got[b, live], want[b, live]) < 2e-4


# ------------------------------------------------------------------ config

def _meta_gguf(path, arch, kv: dict):
    """A GGUF holding only metadata: {key: value} under the arch prefix."""
    w = GGUFWriter(path, arch=arch)
    for k, v in kv.items():
        key = f"{arch}.{k}"
        if isinstance(v, list):
            w.add_array(key, np.asarray(v, np.uint32))
        elif isinstance(v, float):
            w.add_float32(key, v)
        else:
            w.add_uint32(key, v)
    w.write()
    return path


GEMMA_KEYS = {"embedding_length": 3584, "attention.head_count": 16,
              "attention.head_count_kv": 8, "attention.key_length": 256,
              "attention.value_length": 256, "block_count": 42,
              "attention.sliding_window": 4096, "attention.sliding_window_pattern": 2,
              "attn_logit_softcapping": 40.0, "final_logit_softcapping": 20.0,
              "rope.freq_base_swa": 10000.0, "rope.freq_base": 1e6}
SCALE_KEYS = {"embedding_length": 512, "attention.head_count": 4, "embedding_scale": 12.0,
              "residual_scale": 0.22, "logit_scale": 8.0}


@pytest.mark.parametrize("arch,keys", [
    ("gemma", {}), ("gemma2", {}), ("gemma3", {}), ("gemma2", GEMMA_KEYS),
    ("gemma3", GEMMA_KEYS), ("granite", SCALE_KEYS), ("minicpm", SCALE_KEYS),
    ("granitemoe", dict(SCALE_KEYS, expert_count=8, expert_used_count=2))])
def test_config_keys_parse_as_jax(tmp_path, arch, keys):
    """Each new key lands where the JAX parser puts it, and the registry's
    defaults (embedding scale sqrt(n_embd), gemma2's softcaps 50/30,
    gemma3's pattern 6) where the file is silent."""
    path = _meta_gguf(str(tmp_path / "m.gguf"), arch, keys)
    cfg, jcfg = config_from_gguf(GGUFFile(path)), jconfig_from_gguf(JGGUFFile(path))
    assert _fields(cfg) == _fields(jcfg)
    if arch.startswith("gemma"):
        assert cfg.embedding_scale == math.sqrt(cfg.n_embd) and cfg.act_fn == "gelu"
    if arch == "gemma2" and not keys:
        assert (cfg.attn_logit_softcap, cfg.final_logit_softcap) == (50.0, 30.0)


def test_per_layer_swa_pattern_raises(tmp_path):
    """A per-layer sliding_window_pattern array parses since the SWA array
    is ported (exaone4, step35: tests/test_torch_gateup_swa.py), as the JAX
    parser's flags; one with fewer flags than the file's layers (22 by
    default) raises, and so does another per-layer array beside it (gemma4's
    files carry per-layer FFN widths, which stay unported)."""
    keys = {"attention.sliding_window": 512, "attention.sliding_window_pattern": [1, 1, 0]}
    path = _meta_gguf(str(tmp_path / "m.gguf"), "gemma3", keys)
    with pytest.raises(ValueError, match="sliding_window_pattern: 3 flags for 22 layers"):
        config_from_gguf(GGUFFile(path))
    path = _meta_gguf(str(tmp_path / "m3.gguf"), "gemma3", dict(keys, block_count=3))
    cfg = config_from_gguf(GGUFFile(path))
    assert (cfg.swa_layer_pattern, cfg.swa_pattern) == ((True, True, False), 2)
    assert swa_flags(cfg) == [True, True, False] and layer_windows(cfg) == [512, 512, 0]
    path = _meta_gguf(str(tmp_path / "ff.gguf"), "gemma3",
                      dict(keys, block_count=3, feed_forward_length=[1024, 2048, 1024]))
    with pytest.raises(NotImplementedError, match="feed_forward_length"):
        config_from_gguf(GGUFFile(path))


@pytest.mark.parametrize("window,pattern,n_layer", [(0, 1, 4), (32, 1, 4), (32, 2, 5),
                                                    (1024, 6, 34), (4096, 2, 42)])
def test_layer_windows(window, pattern, n_layer):
    """swa_flags is the JAX function; layer_windows gives each layer the
    window the JAX graph applies on a single cache (llama.py:932-950)."""
    kw = dict(sliding_window=window, swa_pattern=pattern, n_layer=n_layer)
    cfg, jcfg = ModelConfig(**kw), JConfig(**kw)
    assert swa_flags(cfg) == jswa_flags(jcfg)
    want = [window if (pattern <= 1 or (li + 1) % pattern) else 0 for li in range(n_layer)]
    assert layer_windows(cfg) == want


# -------------------------------------------------- departures from llama.cpp

def _forward_logits(cfg, params, prompt):
    tok = torch.tensor([prompt])
    pos = torch.arange(len(prompt))[None]
    cache = KVCache.create(cfg, 1, 64, torch.float32, "cpu")
    return forward(params, cfg, tok, pos, cache, 0, torch.zeros(1, dtype=torch.int64),
                   torch.float32)[0]


def test_logit_scale_multiplies(tmp_path):
    """logit_scale multiplies the logits, as the JAX package does
    (llama.py:1546-1547); llama.cpp's granite graph divides by it. Held
    against the JAX engine's first-step logits."""
    path = str(tmp_path / "granite.gguf")
    build_arch_gguf(path, "granite", seed=11)
    cfg, params, _ = load_model(path, device="cpu")
    jcfg, jparams, _ = jload(path)
    prompt = [3, 9, 4, 17, 6]
    base = _forward_logits(cfg, params, prompt)
    scaled = _forward_logits(dataclasses.replace(cfg, logit_scale=4.0), params, prompt)
    assert torch.equal(scaled, base * 4.0)
    jr = JEngine(dataclasses.replace(jcfg, logit_scale=4.0), jparams, max_seq_len=64,
                 compute_dtype=jnp.float32, decode_chunk=4).generate(
        [prompt], max_new_tokens=1, return_logits=True)
    assert _nmse(np.asarray(scaled[:, -1]), np.asarray(jr.logits)) < 1e-6


def test_gemma3_swa_layers_rope_at_global_base_and_scale(gemma_models):
    """Without rope.freq_base_swa, gemma3's SWA layers rope at the global
    base and with the global linear scale (llama.py:722-731; config.py:384),
    as the JAX package does; llama.cpp sets base 10000 and scale 1 for them
    in code. Held against the JAX engine with linear scaling 8; a file
    that gives the SWA base changes the logits."""
    cfg, params, jcfg, jparams = gemma_models["gemma3"]
    kw = dict(rope_base_swa=0.0, rope_base=1e6, rope_scaling="linear", rope_scale=8.0)
    cfg, jcfg = dataclasses.replace(cfg, **kw), dataclasses.replace(jcfg, **kw)
    prompt = PROMPTS[0]
    got = _forward_logits(cfg, params, prompt)[:, -1]
    jr = JEngine(jcfg, jparams, max_seq_len=128, compute_dtype=jnp.float32,
                 decode_chunk=4).generate([prompt], max_new_tokens=1, return_logits=True)
    assert _nmse(np.asarray(got), np.asarray(jr.logits)) < 1e-6
    other = _forward_logits(dataclasses.replace(cfg, rope_base_swa=10000.0), params,
                            prompt)[:, -1]
    assert _nmse(other, got) > 1e-6


@pytest.mark.parametrize("scale_key", [None, 144 ** -0.5])
def test_gemma2_attention_scale(tmp_path, scale_key):
    """Gemma-2-27B's widths (4608 wide, 32 heads of 128): the attention
    scale is attention.scale where the file has it, else 1/sqrt(head_dim)
    (the JAX parser and llama.py:296); llama.cpp hard-codes
    1/sqrt(n_embd / n_head) = 1/12 for the 27B."""
    keys = {"embedding_length": 4608, "attention.head_count": 32,
            "attention.head_count_kv": 16, "attention.key_length": 128,
            "attention.value_length": 128}
    if scale_key:
        keys["attention.scale"] = scale_key
    path = _meta_gguf(str(tmp_path / "m.gguf"), "gemma2", keys)
    cfg, jcfg = config_from_gguf(GGUFFile(path)), jconfig_from_gguf(JGGUFFile(path))
    want = jcfg.attn_scale if jcfg.attn_scale else 1.0 / math.sqrt(jcfg.head_dim)
    scale = attention_params(cfg, True)[0]
    assert scale == pytest.approx(want, rel=1e-7)
    assert scale == pytest.approx(scale_key or 128 ** -0.5, rel=1e-6)


# -------------------------------------------------------------------- synth

def test_gemma_synth():
    """synth_kmajor_q4k_fast for Gemma: the arch row (gelu, embedding scale
    sqrt(n_embd), post-norms, gemma2's softcaps), q n_head * head_dim wide
    over the stream, the lm_head tied to the embedding, the window keys,
    and a forward on the CPU with finite logits of vocab_size."""
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    cfg, params = synth_kmajor_q4k_fast(
        arch="gemma2", vocab_size=300, n_embd=256, n_layer=2, n_head=2, n_head_kv=1,
        head_dim=256, n_ff=512, seed=3, centred=True, device="cpu", exact_vocab=True,
        tied=True, cfg_fields=dict(sliding_window=8))
    assert (cfg.act_fn, cfg.embedding_scale, cfg.post_norms) == ("gelu", 16.0, True)
    assert (cfg.attn_logit_softcap, cfg.final_logit_softcap) == (50.0, 30.0)
    assert cfg.tie_embeddings and params["output"] is params["tok_embd"]
    assert layer_windows(cfg) == [8, 0]
    layers = params["layers"]
    assert layers["post_attn_norm"].shape == layers["post_ffn_norm"].shape == (2, 256)
    assert layers["wqkv"].shape == (2, 512 + 256 + 256, 256)
    lg = _forward_logits(cfg, params, list(range(1, 20)))
    assert lg.shape == (1, 19, 300) and torch.isfinite(lg).all()
    assert lg.abs().max() < 30.0  # the final softcap
