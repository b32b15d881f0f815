"""The iRoPE decoders in the port (llama4, smallthinker, afmoe), held against
the JAX package on the CPU: NoPE layers on a period with llama4's attention
temperature, the weightless L2 QK norm, chunked windows (the einsum path and
kernel C's plain version against the JAX einsum oracle, C's route), the
router reading the residual stream and relu experts (smallthinker), afmoe's
full-width attention gate, post-norm names and dense lead, the context
shift of NoPE layers, the server's prefill bucket on a small ring, and the
config's keys. Small files are written here with numpy draws and read by
both packages' loaders.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_irope.py -q
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGMLType
from tpullm.gguf.writer import GGUFWriter
from tpullm.models.config import ModelConfig as JConfig
from tpullm.models.config import config_from_gguf as jconfig_from_gguf
from tpullm.models.llama import KVCache as JKVCache
from tpullm.models.llama import attention as jattention
from tpullm.models.llama import moe_ffn as jmoe_ffn
from tpullm.ops.flash_attention import flash_attention as jflash
from tpullm.ops.qtensor import qtensor_from_float
from tpullm.runtime.engine import InferenceEngine as JEngine
from tpullm.runtime.loader import _stack_qtensors
from tpullm.runtime.loader import load_model as jload
from tpullm.runtime.memory import _context_shift as j_context_shift
from tpullm.utils import synth as jsynth
from tpullm.utils.synth import _add_quant_tensor, add_spm_toy_vocab, build_arch_gguf
from tpullm_torch.models.config import ModelConfig, config_from_gguf
from tpullm_torch.models.llama import (KVCache, attention_route, attn_temperature, forward,
                                       layer_routes, layer_windows, moe_ffn, nope_flags,
                                       swa_flags)
from tpullm_torch.ops.flash_attention import flash_attention, flash_builds, masked_attention
from tpullm_torch.ops.qtensor import QTensor
from tpullm_torch.runtime.engine import InferenceEngine
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.runtime.memory import SlotMemory, _context_shift
from tpullm_torch.server.context import GenParams, ServerContext, Task

torch.set_num_threads(2)

PROMPTS = [[3, 9, 4, 17, 6], [5, 1, 2], list(range(7, 47))]  # the last: 40 tokens
CHUNK, FLOOR = 16, 8  # llama4's chunk and the temperature floor of the tests


def _nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / max((b ** 2).mean(), 1e-30))


def _fields(c):
    return {k: v for k, v in dataclasses.asdict(c).items() if k != "raw_kv"}


# ------------------------------------------------------------ llama4 files

L4 = dict(n_embd=128, n_layer=4, n_head=4, n_kv=2, head=32, n_exp=4, n_ff=128)


def _llama4_gguf(path, chunk=CHUNK, step=1, seed=5, n_layer=L4["n_layer"]):
    """A 4-layer llama4 file at n_embd 128, as a converted Scout file holds
    it: 4 heads of 32 over 2 kv heads, interleaved RoPE at base 500000,
    every layer MoE (4 Q8_0 experts of 128, top-1, the row's sigmoid
    gating, an F32 router drawn large enough that the two packages pick the
    same expert) with an ungated Q8_0 shared expert of 128, no q/k norm
    tensors, a Q8_0 lm_head and an SPM toy vocab of 256. ``chunk``: the
    attention.sliding_window key (None: not written); ``step``:
    interleave_moe_layer_step; ``n_layer`` the depth."""
    rng = np.random.default_rng(seed)
    rand = lambda *s, sc=0.05: (rng.standard_normal(s) * sc).astype(np.float32)
    a, E, D, F = "llama4", L4["n_exp"], L4["n_embd"], L4["n_ff"]
    w = GGUFWriter(path, arch=a)
    for key, val in (("context_length", 10485760), ("embedding_length", D),
                     ("block_count", n_layer), ("feed_forward_length", 2 * F),
                     ("expert_feed_forward_length", F), ("attention.head_count", L4["n_head"]),
                     ("attention.head_count_kv", L4["n_kv"]),
                     ("attention.key_length", L4["head"]), ("attention.value_length", L4["head"]),
                     ("rope.dimension_count", L4["head"]), ("expert_count", E),
                     ("expert_used_count", 1), ("vocab_size", 256),
                     ("interleave_moe_layer_step", step)):
        w.add_uint32(f"{a}.{key}", val)
    if chunk is not None:
        w.add_uint32(f"{a}.attention.sliding_window", chunk)
    w.add_float32(f"{a}.rope.freq_base", 500000.0)
    w.add_float32(f"{a}.attention.layer_norm_rms_epsilon", 1e-5)
    add_spm_toy_vocab(w, 256)
    q8 = lambda name, arr: _add_quant_tensor(w, name, arr, GGMLType.Q8_0)
    q8("token_embd.weight", rand(256, D, sc=0.5))
    q8("output.weight", rand(256, D))
    w.add_tensor("output_norm.weight", 1 + rand(D))
    nq, nkv = L4["n_head"] * L4["head"], L4["n_kv"] * L4["head"]
    for i in range(n_layer):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", 1 + rand(D))
        w.add_tensor(p + "ffn_norm.weight", 1 + rand(D))
        q8(p + "attn_q.weight", rand(nq, D, sc=0.2))
        q8(p + "attn_k.weight", rand(nkv, D, sc=0.2))
        q8(p + "attn_v.weight", rand(nkv, D, sc=0.2))
        q8(p + "attn_output.weight", rand(D, nq, sc=0.1))
        w.add_tensor(p + "ffn_gate_inp.weight", rand(E, D, sc=1.0))
        for name, shape in (("ffn_gate_exps", (E, F, D)), ("ffn_up_exps", (E, F, D)),
                            ("ffn_down_exps", (E, D, F))):
            _add_quant_tensor(w, p + name + ".weight", rand(*shape, sc=0.1), GGMLType.Q8_0)
        q8(p + "ffn_gate_shexp.weight", rand(F, D, sc=0.1))
        q8(p + "ffn_up_shexp.weight", rand(F, D, sc=0.1))
        q8(p + "ffn_down_shexp.weight", rand(D, F, sc=0.1))
    w.write()
    return path


def _set_floor(cfg, floor=FLOOR):
    """The temperature floor the tests set on both configs (llama4's 8192
    would keep the temperature at 1 over these prompts)."""
    cfg.attn_temp_floor = floor
    return cfg


@pytest.fixture(scope="module")
def llama4(tmp_path_factory):
    """(path, port cfg, port params, JAX cfg, JAX params), the floor set."""
    path = _llama4_gguf(str(tmp_path_factory.mktemp("llama4") / "l4.gguf"))
    jcfg, jparams, _ = jload(path)
    cfg, params, _ = load_model(path, device="cpu")
    return path, _set_floor(cfg), params, _set_floor(jcfg), jparams


def _generate(eng, prompts, n=8):
    return eng.generate(prompts, max_new_tokens=n, return_logits=True)


def test_llama4_config_and_layers(llama4):
    """The port's config of the llama4 file is the JAX parser's field for
    field: the row's chunked 3:1 pattern, NoPE every 4th layer (offset 1:
    layer 3), the temperature scale 0.1, the L2 QK norm, sigmoid top-1. The
    chunk is the file's attention.sliding_window."""
    _, cfg, params, jcfg, _ = llama4
    assert _fields(cfg) == _fields(jcfg)
    assert cfg.swa_chunked and cfg.qk_l2_norm and cfg.expert_gating == "sigmoid"
    assert layer_windows(cfg) == [CHUNK, CHUNK, CHUNK, 0]
    assert nope_flags(cfg) == [False, False, False, True]
    assert cfg.n_expert_used == 1 and "ffn_gate_shexp" in params["layers"]
    assert "moe_gate_inp_shexp" not in params["layers"]  # the shared expert ungated


def test_llama4_engine_matches_jax(llama4):
    """The 4-layer llama4 file through the port's loader and engine against
    the JAX engine, f32 on the CPU: the 40-token prompt crosses two chunk
    boundaries (16, 32) and reaches positions where the NoPE layer's
    temperature is above 1 (floor 8); first-step logits at NMSE < 1e-6,
    8 equal greedy tokens."""
    _, cfg, params, jcfg, jparams = llama4
    temp = attn_temperature(cfg, torch.arange(48)[None]).numpy()[0]
    assert temp[6] == 1.0 and temp[7] > 1.0 and temp[39] > 1.17  # log(6) * 0.1 + 1
    kw = dict(max_seq_len=128, decode_chunk=4)
    jr = _generate(JEngine(jcfg, jparams, compute_dtype=jnp.float32, **kw), PROMPTS)
    r = _generate(InferenceEngine(cfg, params, compute_dtype=torch.float32, device="cpu", **kw),
                  PROMPTS)
    assert _nmse(r.logits, jr.logits) < 1e-6, _nmse(r.logits, jr.logits)
    assert r.tokens == jr.tokens and all(len(t) == 8 for t in r.tokens)


@pytest.mark.parametrize("feature", ["nope", "temperature", "l2_norm", "chunk"])
def test_llama4_features_are_live(llama4, feature):
    """Each of llama4's features moves the logits of the 40-token prompt:
    without NoPE (every layer roped), at temperature 1 (floor 8192), without
    the L2 QK norm, or with a sliding window in place of the chunk, the port
    gives other logits (NMSE > 1e-4)."""
    _, cfg, params, _, _ = llama4
    change = {"nope": dict(no_rope_interval=0), "temperature": dict(attn_temp_floor=8192),
              "l2_norm": dict(qk_l2_norm=False), "chunk": dict(swa_chunked=False)}[feature]
    kw = dict(max_seq_len=128, decode_chunk=4, compute_dtype=torch.float32, device="cpu")
    base = _generate(InferenceEngine(cfg, params, **kw), PROMPTS[2:], 1).logits
    other = _generate(InferenceEngine(dataclasses.replace(cfg, **change), params, **kw),
                      PROMPTS[2:], 1).logits
    assert _nmse(other, base) > 1e-4


def _serve(make, prompts, n_new=8):
    """Greedy tokens of each prompt through a started port ServerContext."""
    ctx = make()
    ctx.start()
    try:
        tasks = [Task(tokens=list(p), params=GenParams(max_tokens=n_new, temperature=0.0,
                                                       ignore_eos=True)) for p in prompts]
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


def _jax_tokens(jcfg, jparams, prompts, n_new=8, **kw):
    """The JAX engine's greedy tokens of each prompt on its own (a batch of
    one, as a server slot runs it)."""
    eng = JEngine(jcfg, jparams, compute_dtype=jnp.float32, decode_chunk=4, **kw)
    return [eng.generate([p], max_new_tokens=n_new).tokens[0] for p in prompts]


@pytest.mark.parametrize("kv", ["bf16", "q8"])
def test_llama4_server_matches_jax_engine(llama4, kv):
    """The llama4 file on the port's ServerContext (2 slots, prefill chunks
    of 32, so the 40-token prompt takes two; f32 compute, the f32 cache or
    the int8 one) against the JAX engine on the same cache type: the same
    greedy tokens for each of the three prompts. Chunked layers get no ring
    (KVCache.create), so the full cache serves them either way."""
    _, cfg, params, jcfg, jparams = llama4
    q8 = kv == "q8"
    got, ctx = _serve(lambda: ServerContext(cfg, params, None, n_slots=2, max_seq_len=128,
                                            decode_chunk=4, prefill_chunk=32,
                                            compute_dtype=torch.float32, device="cpu",
                                            iswa=True, kv_dtype="q8" if q8 else None), PROMPTS)
    want = _jax_tokens(jcfg, jparams, PROMPTS, max_seq_len=128, kv_dtype="q8" if q8 else None)
    assert got == want and all(len(t) == 8 for t in got)
    assert not ctx.memory.cache.dual


def test_interleave_moe_layer_step_gate(tmp_path):
    """interleave_moe_layer_step 1 (every layer MoE, Scout's files) passes;
    2 (Maverick's dense layers between the MoE ones) raises naming them.
    The JAX parser reads no such key and loads either file (its graph then
    runs each layer by its tensors)."""
    ok = _llama4_gguf(str(tmp_path / "one.gguf"))
    two = _llama4_gguf(str(tmp_path / "two.gguf"), step=2)
    from tpullm.gguf.reader import GGUFFile as JFile
    from tpullm_torch.gguf.reader import GGUFFile

    assert config_from_gguf(GGUFFile(ok)).n_expert == 4
    with pytest.raises(NotImplementedError, match="interleave_moe_layer_step=2.*Maverick"):
        config_from_gguf(GGUFFile(two))
    assert jconfig_from_gguf(JFile(two)).n_expert == 4


def test_missing_chunk_key_has_no_chunked_layer(tmp_path):
    """A llama4 file without attention.sliding_window has no chunked layer
    in either package (the JAX parser's window is 0: config.py:240), where
    llama.cpp appears to fix the chunk at 8192 in code: pinned as the JAX
    package computes (ROADMAP §3). The NoPE layer and the temperature stay."""
    from tpullm.gguf.reader import GGUFFile as JFile
    from tpullm_torch.gguf.reader import GGUFFile

    path = _llama4_gguf(str(tmp_path / "nochunk.gguf"), chunk=None)
    cfg, jcfg = config_from_gguf(GGUFFile(path)), jconfig_from_gguf(JFile(path))
    assert cfg.sliding_window == jcfg.sliding_window == 0
    assert layer_windows(cfg) == [0, 0, 0, 0] and cfg.swa_chunked
    assert nope_flags(cfg) == [False, False, False, True]


# ------------------------------------------------------ smallthinker, afmoe

LONG = [[3, 9, 4, 17, 6], [5, 1, 2], list(range(3, 53))]  # the last past the window of 32


def _arch_file(tmp_path_factory, arch, n_layer, dense_lead=None):
    """build_arch_gguf's file of ``arch`` (seed 11: window 32, 4 Q8_0
    experts top-2, the row's keys), at ``n_layer`` layers and, for afmoe,
    a dense lead of ``dense_lead`` layers -> (cfg, params, jcfg, jparams)."""
    path = str(tmp_path_factory.mktemp(arch) / f"{arch}.gguf")
    hints = jsynth.SYNTH_HINTS[arch]
    old = hints.get("dense_lead")
    if dense_lead is not None:
        hints["dense_lead"] = dense_lead
    try:
        build_arch_gguf(path, arch, n_layer=n_layer, seed=11)
    finally:
        if dense_lead is not None:
            hints["dense_lead"] = old
    jcfg, jparams, _ = jload(path)
    cfg, params, _ = load_model(path, device="cpu")
    return cfg, params, jcfg, jparams


@pytest.fixture(scope="module")
def smallthinker(tmp_path_factory):
    return _arch_file(tmp_path_factory, "smallthinker", 4)


@pytest.fixture(scope="module")
def afmoe(tmp_path_factory):
    """afmoe at 8 layers with a dense lead of 4: its groups then start on a
    multiple of the NoPE period, where the JAX graph's group-relative layer
    index names the same NoPE and SWA layers as the model's index
    (test_afmoe_nope_layers_by_model_index pins the other case)."""
    return _arch_file(tmp_path_factory, "afmoe", 8, dense_lead=4)


def _engines(cfg, params, jcfg, jparams, iswa, jiswa, kv=None):
    """(port result, JAX result) of LONG, f32, 8 greedy tokens; the port's
    cache dual with ``iswa``, the JAX engine's with ``jiswa``; ``kv`` "q8"
    for the int8 cache on both."""
    kw = dict(max_seq_len=128, decode_chunk=4, prefill_chunk=16, kv_dtype=kv)
    r = _generate(InferenceEngine(cfg, params, compute_dtype=torch.float32, device="cpu",
                                  iswa=iswa, **kw), LONG)
    jr = _generate(JEngine(jcfg, jparams, compute_dtype=jnp.float32, iswa=jiswa, **kw), LONG)
    return r, jr


def test_smallthinker_config_and_layers(smallthinker):
    """smallthinker's parse is the JAX parser's: the row's relu experts,
    renormalized, the router on the residual stream; with a window the
    NoPE period is the SWA period (config.py:405-408), offset 0, so the
    dense-first pattern's full layer 0 takes no RoPE and the SWA layers 1-3
    do."""
    cfg, params, jcfg, _ = smallthinker
    assert _fields(cfg) == _fields(jcfg)
    assert cfg.act_fn == "relu" and cfg.moe_router_pre_norm and cfg.no_rope_interval == 4
    assert swa_flags(cfg) == [False, True, True, True]
    assert layer_windows(cfg) == [0, 32, 32, 32]
    assert nope_flags(cfg) == [True, False, False, False]


@pytest.mark.parametrize("iswa", [False, True], ids=["full", "ring"])
def test_smallthinker_engine_matches_jax(smallthinker, iswa):
    """The 4-layer smallthinker file on the port's engine (the full cache or
    the iSWA ring of window + 16 slots) against the JAX engine on its dual
    cache, f32: the 50-token prompt past the window of 32, first-step
    logits at NMSE < 1e-6 and equal greedy tokens. The JAX dual cache
    windows the layers swa_flags names (the dense-first pattern), as the
    port does on both caches."""
    r, jr = _engines(*smallthinker, iswa, True)
    assert _nmse(r.logits, jr.logits) < 1e-6, _nmse(r.logits, jr.logits)
    assert r.tokens == jr.tokens


def test_jax_single_cache_ignores_dense_first(smallthinker):
    """The JAX engine on its single cache windows the interleaved layers
    where (li + 1) % swa_pattern != 0 (llama.py:937-939), which ignores
    smallthinker's dense-first pattern (its SWA layers 0-2, not 1-3): its
    logits of the 50-token prompt leave its own dual cache's and the
    port's (NMSE > 1e-3). Pinned as the JAX package computes (ROADMAP §3);
    the port follows swa_flags, as llama.cpp's dense-first pattern does."""
    cfg, params, jcfg, jparams = smallthinker
    r, jr = _engines(cfg, params, jcfg, jparams, False, False)
    _, jr_dual = _engines(cfg, params, jcfg, jparams, False, True)
    assert _nmse(jr.logits, jr_dual.logits) > 1e-3
    assert _nmse(r.logits, jr_dual.logits) < 1e-6


def test_smallthinker_server_on_the_ring(smallthinker):
    """The smallthinker file on the port's ServerContext with the iSWA ring
    (prefill chunks of 16: a ring of 48 slots, which the 50-token prompt
    wraps) against the JAX engine on its dual cache: the same greedy
    tokens."""
    cfg, params, jcfg, jparams = smallthinker
    got, ctx = _serve(lambda: ServerContext(cfg, params, None, n_slots=2, max_seq_len=128,
                                            decode_chunk=4, prefill_chunk=16,
                                            compute_dtype=torch.float32, device="cpu",
                                            iswa=True), LONG)
    assert ctx.memory.cache.dual and ctx.memory.cache.ring == 48
    assert got == _jax_tokens(jcfg, jparams, LONG, max_seq_len=128, iswa=True, prefill_chunk=16)


def test_afmoe_config_and_layers(afmoe):
    """afmoe's parse is the JAX parser's: the embedding scale sqrt(n_embd)
    from the row's sentinel, SWA 3:1 with its full layers NoPE (offset 1),
    the post-norms under afmoe's names, the attention gate as wide as the
    attention output, the dense lead as its own layer group."""
    cfg, params, jcfg, _ = afmoe
    assert _fields(cfg) == _fields(jcfg)
    assert cfg.embedding_scale == pytest.approx(64 ** 0.5)
    assert layer_windows(cfg) == [32, 32, 32, 0] * 2
    assert nope_flags(cfg) == [False, False, False, True] * 2
    dense, moe = params["layers"]["__groups__"]
    for gl in (dense, moe):
        assert {"post_attn_norm", "post_ffn_norm", "q_norm", "k_norm"} <= set(gl)
        assert tuple(gl["wqkv_gate"].shape[-2:]) == (cfg.n_head * cfg.head_dim_v, cfg.n_embd)
    assert "moe_gate_inp" not in dense and "moe_probs_b" in moe


@pytest.mark.parametrize("kv", ["full", "ring", "q8"])
def test_afmoe_engine_matches_jax(afmoe, kv):
    """The 8-layer afmoe file (a dense lead of 4, then 4 MoE layers with the
    selection bias and the shared expert) on the port's engine against the
    JAX engine on the same cache (full, the iSWA ring of window + 16 slots,
    int8), f32: the 50-token prompt past the window, first-step logits at
    NMSE < 1e-6 (the int8 caches within 1e-5 of each other) and equal
    greedy tokens."""
    ring, q8 = kv == "ring", kv == "q8"
    r, jr = _engines(*afmoe, ring, ring, "q8" if q8 else None)
    assert _nmse(r.logits, jr.logits) < (1e-5 if q8 else 1e-6), _nmse(r.logits, jr.logits)
    assert r.tokens == jr.tokens


@pytest.mark.parametrize("kv", ["full", "ring"])
def test_afmoe_four_moe_layers_match_jax(tmp_path_factory, kv):
    """A 4-layer afmoe file without a dense lead (every layer MoE: one
    group, where the JAX group index is the model's): layers 0-2 windowed,
    layer 3 full and NoPE, on the port's engine against the JAX engine on
    the same cache, f32: first-step logits at NMSE < 1e-6, equal greedy
    tokens."""
    cfg, params, jcfg, jparams = _arch_file(tmp_path_factory, "afmoe", 4, dense_lead=0)
    assert "__groups__" not in params["layers"] and nope_flags(cfg)[3]
    r, jr = _engines(cfg, params, jcfg, jparams, kv == "ring", kv == "ring")
    assert _nmse(r.logits, jr.logits) < 1e-6, _nmse(r.logits, jr.logits)
    assert r.tokens == jr.tokens


@pytest.mark.parametrize("kv", ["ring", "q8"])
def test_afmoe_server_matches_jax_engine(afmoe, kv):
    """The afmoe file on the port's ServerContext, on the iSWA ring (prefill
    chunks of 32: a ring of 64 slots, which the 50-token prompt wraps) and
    on the int8 full cache, against the JAX engine on the same cache: the
    same greedy tokens."""
    cfg, params, jcfg, jparams = afmoe
    ring = kv == "ring"
    got, ctx = _serve(lambda: ServerContext(cfg, params, None, n_slots=2, max_seq_len=128,
                                            decode_chunk=4, prefill_chunk=32,
                                            compute_dtype=torch.float32, device="cpu",
                                            iswa=ring, kv_dtype=None if ring else "q8"), LONG)
    assert ctx.memory.cache.dual == ring
    want = _jax_tokens(jcfg, jparams, LONG, max_seq_len=128, iswa=ring, prefill_chunk=32,
                       kv_dtype=None if ring else "q8")
    assert got == want


def test_afmoe_nope_layers_by_model_index(tmp_path_factory):
    """With a dense lead of 1 (build_arch_gguf's afmoe) the depth splits into
    groups at layer 1: the port takes layer 3 as NoPE and full, by its index
    in the model, as llama.cpp counts layers; the JAX graph counts within
    each group (the scan's ids, llama.py:1443), so its MoE group's layers
    1-3 are 0-2 there: none NoPE, all windowed. The two engines' logits then
    differ (NMSE > 1e-3): pinned as the JAX package computes (ROADMAP §3).

    The oracle of the port's layers is the JAX engine on the same weights
    with its group index made the model's: the windows as an explicit
    per-layer array, which the JAX graph indexes by the model's layer
    (``swa_arr[li + g_off]``, llama.py:939), and the NoPE offset moved by
    the lead, so the MoE group's index li - 1 names layer li (the dense
    layer 0 stays roped either way). Against it the port's f32 first-step
    logits are at NMSE < 1e-6 and its greedy tokens equal."""
    lead = 1
    cfg, params, jcfg, jparams = _arch_file(tmp_path_factory, "afmoe", 4, dense_lead=lead)
    assert len(params["layers"]["__groups__"]) == 2
    assert nope_flags(cfg) == [False, False, False, True]
    assert layer_windows(cfg) == [32, 32, 32, 0]
    jgroup_relative = [(li + jcfg.no_rope_offset) % jcfg.no_rope_interval == 0
                       for li in (0, 0, 1, 2)]
    assert jgroup_relative == [False] * 4
    r, jr = _engines(cfg, params, jcfg, jparams, False, False)
    assert _nmse(r.logits, jr.logits) > 1e-3
    by_model = dataclasses.replace(jcfg, swa_layer_pattern=tuple(swa_flags(cfg)),
                                   no_rope_offset=jcfg.no_rope_offset + lead)
    assert [(gi + by_model.no_rope_offset) % by_model.no_rope_interval == 0
            for gi in (0, 0, 1, 2)] == [False, False, False, True]
    _, oracle = _engines(cfg, params, by_model, jparams, False, False)
    assert _nmse(r.logits, oracle.logits) < 1e-6, _nmse(r.logits, oracle.logits)
    assert r.tokens == oracle.tokens


def test_server_bucket_on_a_small_ring(afmoe):
    """The server's prefill bucket cut to the ring's room (ROADMAP §3,
    repaired): the afmoe file at a window of 16 (set on both configs) on a
    ring of window + 8 = 24 slots (prefill chunks of 8), under window + 32,
    so the old bucket of 32 rows would write padding over ring slots its
    own queries still see. The server's greedy tokens equal the port's
    engine's on the full cache and the JAX engine's."""
    cfg, params, jcfg, jparams = afmoe
    cfg = dataclasses.replace(cfg, sliding_window=16)
    jcfg = dataclasses.replace(jcfg, sliding_window=16)
    got, ctx = _serve(lambda: ServerContext(cfg, params, None, n_slots=2, max_seq_len=128,
                                            decode_chunk=4, prefill_chunk=8,
                                            compute_dtype=torch.float32, device="cpu",
                                            iswa=True), LONG)
    assert ctx.memory.cache.dual and ctx.memory.cache.ring == 24
    eng = InferenceEngine(cfg, params, max_seq_len=128, decode_chunk=4,
                          compute_dtype=torch.float32, device="cpu")
    assert got == [eng.generate([p], max_new_tokens=8).tokens[0] for p in LONG]
    assert got == _jax_tokens(jcfg, jparams, LONG, max_seq_len=128)


# ------------------------------------------------------- the chunked mask

def _attn_inputs(T, first, S, vf=(0, 5), H=4, Hkv=2, D=128, seed=0):
    """q (B,T,H,D), head-major k/v (B,Hkv,S,D) f32, query slots
    first..first+T-1, each row with its valid_from: numpy."""
    rng = np.random.default_rng(seed)
    B = len(vf)
    q = (rng.standard_normal((B, T, H, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, Hkv, S, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, Hkv, S, D)) * 0.5).astype(np.float32)
    vf = np.asarray(vf, np.int64)
    qs = np.broadcast_to(first + np.arange(T)[None], (B, T)).copy()
    kvp = np.arange(S)[None] - vf[:, None]
    return q, k, v, qs, kvp, qs - vf[:, None], vf


@pytest.mark.parametrize("T,first,S,window", [(128, 0, 256, 64), (128, 96, 256, 64),
                                               (128, 100, 256, 48), (8, 40, 64, 16),
                                               (1, 47, 64, 16)],
                         ids=["T128_slot0", "T128_straddle", "T128_w48", "T8", "T1"])
def test_chunked_plain_c_matches_jax_attention(T, first, S, window):
    """The chunked window on the port's einsum path (masked_attention) and
    in kernel C's plain version (flash_attention on CPU tensors) against
    the JAX einsum attention (llama.py:335-337), f32, on blocks that start
    at, straddle and cross chunk boundaries, with a nonzero valid_from:
    NMSE < 1e-10 (summation order). The chunk moves the output from the
    sliding window's."""
    q, k, v, qs, kvp, pos, vf = _attn_inputs(T, first, S)
    kw = dict(n_head=4, n_head_kv=2, head_dim=128, head_dim_v=128, sliding_window=window,
              swa_chunked=True, swa_pattern=1)
    want = np.asarray(jattention(*(jnp.asarray(a) for a in (q, k, v, qs, kvp, pos, vf)),
                                 JConfig(**kw), True))
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, qs, kvp, pos, vf)]
    got = flash_attention(*t, ModelConfig(**kw), True).numpy()
    assert _nmse(got, want) < 1e-10
    plain = masked_attention(*t, 1 / np.sqrt(128), window=window, chunked=True).numpy()
    assert _nmse(plain, want) < 1e-10
    sliding = masked_attention(*t, 1 / np.sqrt(128), window=window).numpy()
    assert _nmse(sliding, want) > 1e-3


def test_jax_flash_kernel_masks_chunks_as_sliding():
    """The JAX package's Pallas prefill kernel (interpret mode) takes a
    chunked layer's window as a sliding one (flash_attention.py:61-64): at
    queries past the first chunk it gives the sliding window's output, not
    the chunk's of its einsum path. Pinned as the JAX package computes
    (ROADMAP §3); the port's C masks by chunk (its own route)."""
    q, k, v, qs, kvp, pos, vf = _attn_inputs(128, 96, 256)
    kw = dict(n_head=4, n_head_kv=2, head_dim=128, head_dim_v=128, sliding_window=64,
              swa_chunked=True, swa_pattern=1, n_embd=512)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    ji = lambda a: jnp.asarray(a, jnp.int32)
    pallas = np.asarray(jflash(jb(q), jb(k), jb(v), ji(qs), ji(kvp), ji(pos), ji(vf),
                               JConfig(**kw), True, interpret=True), np.float32)
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, qs, kvp, pos, vf)]
    sliding = masked_attention(*t, 1 / np.sqrt(128), window=64).numpy()
    chunked = masked_attention(*t, 1 / np.sqrt(128), window=64, chunked=True).numpy()
    assert _nmse(pallas, sliding) < 2e-4 and _nmse(pallas, chunked) > 1e-3


def test_chunked_calls_take_c_only_through_its_chunked_build():
    """attention_route sends a chunked prefill call to C where C builds the
    chunk (flash_builds(..., chunked=True): a plain view), and never over a
    ring, which C's chunk does not take (the dual cache builds none for
    chunked layers); decode stays E's, whose plain view takes the chunk."""
    args = (True, 2, 128, 256, 128, 128, 8, 2, torch.bfloat16)
    assert flash_builds(128, 256, 128, 128, 8, 2, chunked=True)
    assert not flash_builds(128, 256, 128, 128, 8, 2, ring=256, chunked=True)
    assert attention_route(*args, chunked=True) == "flash_attention"
    ring = (True, 2, 128, 256, 128, 128, 8, 2, torch.bfloat16, 256)
    assert attention_route(*ring) == "flash_attention"
    assert attention_route(*ring, chunked=True) == "einsum"
    with pytest.raises(ValueError, match="chunked"):
        q = torch.zeros((1, 4, 4, 128))
        kv = torch.zeros((1, 2, 64, 128))
        z = torch.zeros((1, 4), dtype=torch.int64)
        flash_attention(q, kv, kv, z, torch.zeros((1, 64), dtype=torch.int64), z,
                        torch.zeros(1, dtype=torch.int64),
                        ModelConfig(n_head=4, n_head_kv=2, head_dim=128, sliding_window=16,
                                    swa_chunked=True), True, ring=64)


def test_fold_off_under_nope_layers(tmp_path):
    """layer_routes keeps the layer kernel's fold off where the config has
    NoPE layers (no_rope_interval), as the JAX gate does (llama.py:1422):
    the folded kernel emits the next layer's QKV, which the attend of a NoPE
    layer must take unroped and temperature-scaled. The block itself stays
    where its own gate holds."""
    from tpullm.utils.synth import build_llama_gguf

    path = build_llama_gguf(str(tmp_path / "m.gguf"), vocab_size=256, n_embd=512, n_layer=2,
                            n_head=4, n_head_kv=2, n_ff=512, qtype=GGMLType.Q4_K, seed=1)
    cfg, params, _ = load_model(path, device="cpu")
    gl = params["layers"]
    qw = {k: v for k, v in gl.items() if isinstance(v, QTensor)}
    assert layer_routes(cfg, gl, qw, 4, 1, True, 1) == (True, True)
    nope = dataclasses.replace(cfg, no_rope_interval=4)
    assert layer_routes(nope, gl, qw, 4, 1, True, 1) == (True, False)


# ----------------------------------------------------------- the shift

SHIFT_CFG = dict(arch="llama4", n_layer=4, n_head=4, n_head_kv=2, head_dim=32, head_dim_v=32,
                 rope_dim=32, rope_base=500000.0, no_rope_interval=4, swa_chunked=True)


def _random_cache(kv, seed=3):
    """A 4-layer cache of 3 slots x 48 rows, 2 kv heads of 32, random rows
    (the int8 cache with its row scales), on the CPU."""
    cfg = ModelConfig(**SHIFT_CFG)
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.standard_normal((4, 3, 2, 48, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((4, 3, 2, 48, 32)).astype(np.float32))
    cache = KVCache.create(cfg, 3, 48, torch.float32 if kv == "f32" else kv, "cpu")
    if kv == "q8":
        from tpullm_torch.models.llama import _kv_quant

        (cache.k[:], cache.ks[:]), (cache.v[:], cache.vs[:]) = _kv_quant(k), _kv_quant(v)
    else:
        cache.k.copy_(k)
        cache.v.copy_(v)
    return cfg, cache


@pytest.mark.parametrize("kv", ["f32", "q8"])
def test_shift_moves_nope_rows_unrotated(kv):
    """The port's shift on a llama4 config (layer 3 NoPE): the moved K rows
    of layer 3 move as they are (bit for bit on the f32 cache, requantized
    within half a step on the int8 one), those of layers 0-2 are rotated
    exactly as a config without NoPE layers rotates them; V and the other
    slots move or stay as before."""
    cfg, cache = _random_cache(kv)
    _, ref = _random_cache(kv)
    old_k = cache.k.clone()
    slot, n_keep, nd, n_past = 1, 4, 10, 40
    _context_shift(cache, cfg, slot, n_keep, nd, n_past)
    _context_shift(ref, dataclasses.replace(cfg, no_rope_interval=0), slot, n_keep, nd, n_past)
    mv, src = slice(n_keep, n_past - nd), slice(n_keep + nd, n_past)
    assert torch.equal(cache.k[:3], ref.k[:3]) and torch.equal(cache.v, ref.v)
    if kv == "q8":
        got = cache.k[3, slot, :, mv].float() * cache.ks[3, slot, :, mv][..., None]
        was = old_k[3, slot, :, src].float() * _random_cache(kv)[1].ks[3, slot, :, src][..., None]
        assert float((got - was).abs().max()) <= 0.51 * float(cache.ks[3].max())
    else:
        assert torch.equal(cache.k[3, slot, :, mv], old_k[3, slot, :, src])
        assert not torch.equal(ref.k[3, slot, :, mv], old_k[3, slot, :, src])
    for other in (0, 2):
        assert torch.equal(cache.k[:, other], old_k[:, other])


def test_jax_shift_rotates_nope_rows():
    """The JAX package's shift rotates every layer's moved K rows
    (memory.py:301-311), the NoPE layer's too: pinned as it computes
    (ROADMAP §3)."""
    cfg, cache = _random_cache("f32")
    old = cache.k.numpy().copy()
    jcfg = JConfig(**SHIFT_CFG)
    slot, n_keep, nd, n_past = 1, 4, 10, 40
    jnew = j_context_shift(JKVCache(jnp.asarray(cache.k.numpy()), jnp.asarray(cache.v.numpy())),
                           jnp.int32(slot), jnp.int32(n_keep), jnp.int32(nd), jnp.int32(n_past),
                           cfg=jcfg)
    moved = np.asarray(jnew.k[3, slot, :, n_keep:n_past - nd]).astype(np.float32)
    was = old[3, slot, :, n_keep + nd:n_past].astype(jnp.bfloat16).astype(np.float32)
    assert np.abs(moved - was).max() > 0.1
    _context_shift(cache, ModelConfig(**SHIFT_CFG), slot, n_keep, nd, n_past)
    np.testing.assert_array_equal(cache.k[3, slot, :, n_keep:n_past - nd].numpy(),
                                  old[3, slot, :, n_keep + nd:n_past])


@pytest.mark.parametrize("kv", [torch.float32, "q8"])
def test_nope_shift_decodes_as_reprefill(tmp_path, kv):
    """The oracle of the NoPE shift: a 1-layer llama4 model whose layer is
    NoPE (no_rope_offset 0; its K rows depend on their token alone), the
    window off, the temperature floor 8: a slot prefilled with 30 tokens and
    shifted (keep 4, discard 9) decodes the next token as a slot prefilled
    with the 21 kept tokens at their new positions does (NMSE < 1e-6 in
    f32, 1e-3 on the int8 cache), and their K rows agree. Rotating the
    moved rows, as the JAX shift does, breaks it."""
    path = _llama4_gguf(str(tmp_path / "one.gguf"), n_layer=1)
    cfg, params, _ = load_model(path, device="cpu")
    cfg = dataclasses.replace(cfg, no_rope_offset=0, sliding_window=0, attn_temp_floor=8)
    assert nope_flags(cfg) == [True]
    seq = np.random.default_rng(5).integers(0, 256, 30).tolist()
    n_keep, nd = 4, 9
    kept = seq[:n_keep] + seq[n_keep + nd:]
    vf = torch.zeros(1, dtype=torch.int64)

    def prefill(mem, toks):
        forward(params, cfg, torch.tensor([toks]), torch.arange(len(toks))[None], mem.cache, 0,
                vf, torch.float32, slot0=0)
        mem.slots[0].n_past, mem.slots[0].tokens = len(toks), list(toks)

    def step(mem, tok):
        n = mem.slots[0].n_past
        lg, _ = forward(params, cfg, torch.tensor([[tok]]), torch.tensor([[n]]), mem.cache,
                        torch.tensor([n]), vf, torch.float32, kv_view_len=64, slot0=0)
        return lg[0, -1].numpy()

    shifted = SlotMemory(cfg, 1, 64, kv, "cpu")
    prefill(shifted, seq)
    shifted.context_shift(0, n_keep, nd)
    rotated = SlotMemory(cfg, 1, 64, kv, "cpu")
    prefill(rotated, seq)
    _context_shift(rotated.cache, dataclasses.replace(cfg, no_rope_interval=0), 0, n_keep, nd, 30)
    rotated.slots[0].n_past, rotated.slots[0].tokens = 21, kept
    fresh = SlotMemory(cfg, 1, 64, kv, "cpu")
    prefill(fresh, kept)
    if kv == torch.float32:
        torch.testing.assert_close(shifted.cache.k[..., :21, :], fresh.cache.k[..., :21, :],
                                   rtol=1e-5, atol=1e-5)
    got, want, bad = step(shifted, 11), step(fresh, 11), step(rotated, 11)
    assert _nmse(got, want) < (1e-6 if kv == torch.float32 else 1e-3), _nmse(got, want)
    assert _nmse(bad, want) > 1e-3


# ------------------------------------------------------------ the MoE FFN

def _moe_layer(rng, E=4, D=128, F=128):
    """One MoE layer's (qw, p) in both packages: Q8_0 expert stacks of
    (1, E, ...), an F32 router."""
    qw, jqw = {}, {}
    for name, shape in (("moe_gate_exps", (E, F, D)), ("moe_up_exps", (E, F, D)),
                        ("moe_down_exps", (E, D, F))):
        arr = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        jq = _stack_qtensors([qtensor_from_float(arr, GGMLType.Q8_0, device_put=False)])
        jqw[name] = jq
        qw[name] = QTensor(GGMLType(int(jq.qtype)), tuple(jq.shape),
                           {k: torch.from_numpy(np.array(v)) for k, v in jq.data.items()})
    router = (rng.standard_normal((E, D)) * 0.5).astype(np.float32)
    jr = _stack_qtensors([qtensor_from_float(router, GGMLType.F32, device_put=False)])
    jqw["moe_gate_inp"] = jr
    qw["moe_gate_inp"] = QTensor(GGMLType.F32, tuple(jr.shape),
                                 {k: torch.from_numpy(np.array(v)) for k, v in jr.data.items()})
    return qw, jqw


@pytest.mark.parametrize("act,pre", [("relu", True), ("relu", False), ("silu", True)])
def test_moe_ffn_relu_and_router_input_match_jax(act, pre):
    """moe_ffn with smallthinker's relu experts and its router reading
    another input (router_x: the residual stream) against the JAX moe_ffn
    (its CPU loop), f32, top-2 of 4 renormalized: NMSE < 1e-10. The router
    input is live: another one routes other rows."""
    rng = np.random.default_rng(2)
    qw, jqw = _moe_layer(rng)
    x = (rng.standard_normal((2, 5, 128))).astype(np.float32)
    rx = (rng.standard_normal((2, 5, 128))).astype(np.float32)
    kw = dict(n_expert=4, n_expert_used=2, expert_weights_norm=True, act_fn=act, n_embd=128)
    want = np.asarray(jmoe_ffn(jnp.asarray(x), {}, jqw, 0, JConfig(**kw), jnp.float32,
                               router_x=jnp.asarray(rx) if pre else None))
    got = moe_ffn(torch.from_numpy(x), qw, 0, ModelConfig(**kw), torch.float32,
                  router_x=torch.from_numpy(rx) if pre else None).numpy()
    assert _nmse(got, want) < 1e-10
    other = moe_ffn(torch.from_numpy(x), qw, 0, ModelConfig(**kw), torch.float32,
                    router_x=None if pre else torch.from_numpy(rx)).numpy()
    assert _nmse(other, want) > 1e-3


def test_weight_after_the_experts_as_jax():
    """llama4's routing weight scales each expert's output, as the JAX
    moe_ffn does (llama.py:441-442), where llama.cpp appears to scale the
    expert's input for llama4 (build_moe_ffn's weight_before_ffn). Through
    the gated SiLU the two differ; the port is the JAX one (NMSE < 1e-10)
    and the input-scaled one moves it: pinned (ROADMAP §3)."""
    rng = np.random.default_rng(4)
    qw, jqw = _moe_layer(rng)
    x = (rng.standard_normal((1, 6, 128))).astype(np.float32)
    kw = dict(n_expert=4, n_expert_used=1, expert_gating="sigmoid", n_embd=128)
    want = np.asarray(jmoe_ffn(jnp.asarray(x), {}, jqw, 0, JConfig(**kw), jnp.float32))
    cfg = ModelConfig(**kw)
    got = moe_ffn(torch.from_numpy(x), qw, 0, cfg, torch.float32).numpy()
    assert _nmse(got, want) < 1e-10
    xt = torch.from_numpy(x)
    logits = xt @ qw["moe_gate_inp"].dequant(torch.float32)[0].T
    w, top = torch.sigmoid(logits).max(-1)
    before = torch.zeros_like(xt)
    for e in range(4):  # each row's expert on its input times its weight
        rows = top == e
        one = {k: QTensor(v.qtype, v.shape[2:], {n: d[0, e] for n, d in v.data.items()})
               for k, v in qw.items() if k != "moe_gate_inp"}
        xi = xt * w[..., None]
        g = xi @ one["moe_gate_exps"].dequant(torch.float32).T
        u = xi @ one["moe_up_exps"].dequant(torch.float32).T
        y = (torch.nn.functional.silu(g) * u) @ one["moe_down_exps"].dequant(torch.float32).T
        before = torch.where(rows[..., None], y, before)
    assert _nmse(before.numpy(), want) > 1e-4
