"""The dense decoder's flags in the port held against the JAX package on the
CPU: per-head and flat q/k norms, the q/k/v biases, the GGUF-fused attn_qkv
with its bias, the post-norms with and without the pre-norms. Every arch
the port's registry gained goes through its arch snapshot; qwen3, qwen2,
qwen, glm4 and olmo2 at Q4_K K-major widths through both packages (the
port's loader and the params carried across); a port ServerContext against
a JAX one on qwen3 and qwen2; each arch's layer-kernel and fold decision
against the JAX conditions; the Qwen2 synth vocab and its template.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_arch_flags.py -q
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGMLType
from tpullm.ops.layer_kernel import supported as jblock_supported
from tpullm.ops.qtensor import QTensor as JQTensor
from tpullm.runtime.engine import InferenceEngine as JEngine
from tpullm.runtime.loader import load_model as jload
from tpullm.server.context import GenParams as JGenParams
from tpullm.server.context import ServerContext as JServerContext
from tpullm.server.context import Task as JTask
from tpullm.utils.synth import build_arch_gguf, build_deepseek2_gguf, build_llama_gguf
from tpullm_torch.models.llama import SCALE_KEYS, KVCache, forward, layer_routes
from tpullm_torch.models.registry import ARCH_REGISTRY
from tpullm_torch.ops.qtensor import QTensor
from tpullm_torch.runtime.engine import InferenceEngine
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.server.context import GenParams, ServerContext, Task
from tpullm_torch.utils.from_jax import params_from_numpy

torch.set_num_threads(2)

SNAP_DIR = os.path.join(os.path.dirname(__file__), "snapshots")
# the archs whose flags this port runs, and the llama-shaped rows that run
# on the dense path as it was
FLAG_ARCHS = ["qwen2", "qwen", "qwen3", "hunyuan-dense", "maincoder", "glm4", "exaone4",
              "olmo2"]
PLAIN_ARCHS = ["mistral", "mistral3", "internlm2", "exaone", "baichuan", "xverse", "seed_oss",
               "ernie4_5"]
# the scale keys (granite, minicpm; granitemoe with experts and a residual
# scale of 0.5) and the gemma family (gelu, embedding scale, softcaps,
# sliding windows): their snapshots run the port's new fields
SCALE_ARCHS = ["granite", "minicpm", "granitemoe"]
GEMMA_ARCHS = ["gemma", "gemma2", "gemma3"]
# the layernorm, bias and parallel-residual rows (their snapshots and the
# rest of their cases are in tests/test_torch_layernorm.py)
LAYERNORM_ARCHS = ["stablelm", "orion", "cohere2", "olmo", "starcoder2", "codeshell",
                   "nemotron", "jais2", "arcee", "phi2", "command-r", "gptneox", "falcon",
                   "gptj", "plamo"]
# the rows without RoPE: learned positions and ALiBi (their cases are in
# tests/test_torch_positions.py)
POSITION_ARCHS = ["gpt2", "starcoder", "bloom", "mpt", "jais", "refact"]
# the rows whose files run on the paths above as they are (the dense and the
# MoE ones), and the MoE rows with leading dense layers and the router's
# selection bias (their other cases are in tests/test_torch_moe_bias.py)
AS_IS_ARCHS = ["llama-embed", "qwen2vl", "qwen3vl", "smollm3", "hunyuan_vl", "paddleocr",
               "pangu-embedded", "kimi-linear", "deepseek", "olmoe", "phimoe", "hunyuan-moe",
               "qwen3vlmoe"]
LEAD_BIAS_ARCHS = ["ernie4_5-moe", "glm4moe", "deepseek2-ocr", "exaone-moe", "dots1",
                   "bailingmoe", "bailingmoe2", "minimax-m2"]
# the MLA rows (their other cases are in tests/test_torch_mla.py): minicpm3's,
# mistral4's and plm's snapshots come from build_deepseek2_gguf, as in
# tests/test_arch_snapshots.py:44-49; glm-dsa's from build_arch_gguf (its
# dense layers, the router's gating in its row); deepseek2 has no snapshot
MLA_ARCHS = ["minicpm3", "mistral4", "plm", "glm-dsa"]
# the rows of the GGUF-combined [gate; up] (phi3, chatglm, plamo3, with the
# fused attn_qkv) and of the per-layer SWA array with the per-head attention
# gate (step35); their other cases are in tests/test_torch_gateup_swa.py
GATEUP_SWA_ARCHS = ["phi3", "chatglm", "plamo3", "step35"]
# the rows with attention sinks (gpt-oss: the clamped swiglu_oai and q/k/v
# biases; mimo2: the SWA array, the value scale and a sigmoid MoE with the
# selection bias); their other cases are in tests/test_torch_sinks.py
SINK_ARCHS = ["gpt-oss", "mimo2"]
# the iRoPE rows (NoPE layers on a period; llama4's chunked windows,
# temperature and L2 QK norm; smallthinker's relu experts and router input;
# afmoe's full-width attention gate); their other cases are in
# tests/test_torch_irope.py
IROPE_ARCHS = ["llama4", "smallthinker", "afmoe"]
# the other MoE families (dbrx's layernorm, grok's GELU experts beside a
# dense FFN, arctic's parallel MoE, grovemoe's chunk experts); their other
# cases are in tests/test_torch_moe_families.py
MOE_FAMILY_ARCHS = ["dbrx", "grok", "arctic", "grovemoe"]
# the per-layer-embedding Gemmas (their other cases are in
# tests/test_torch_gemma_ple.py): gemma4's snapshot (build_arch_gguf's
# gemma4: gemma4's attention and post-norms, no per-layer stream) runs here;
# gemma3n has no snapshot to hold, since the JAX package's own fails
# (build_arch_gguf writes no altup_proj: KeyError in its forward; ROADMAP §3),
# so it is held against the JAX engine on build_gemma3n_gguf instead
PLE_ARCHS = ["gemma4"]
PLE_ARCHS_NO_SNAPSHOT = ["gemma3n"]
# the dense singles (chameleon's per-head layernorm QK norm, apertus's xIELU,
# bitnet's sub-norms and scales, cogvlm's text path); their other cases are
# in tests/test_torch_dense_singles.py
SINGLE_ARCHS = ["chameleon", "apertus", "bitnet", "cogvlm"]
KMAJOR_ARCHS = ["qwen3", "qwen2", "qwen", "glm4", "olmo2"]
PROMPTS = [[3, 9, 4, 17, 6], [5, 1, 2], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 2, 3, 4, 5,
                                         6, 7, 8, 9, 30]]


def _nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / max((b ** 2).mean(), 1e-30))


def _flatten(v):
    """JAX params -> the plain nested data params_from_numpy takes."""
    if isinstance(v, JQTensor):
        return {"qtype": int(v.qtype), "shape": tuple(v.shape),
                "data": {k: np.asarray(a) for k, a in v.data.items()}}
    if isinstance(v, dict):
        return {k: _flatten(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_flatten(x) for x in v]
    return np.asarray(v)


def test_registry_rows_are_the_jax_rows():
    """Each of the port's rows is the JAX package's row as it is."""
    from tpullm.models.registry import ARCH_REGISTRY as JREG

    assert set(FLAG_ARCHS + PLAIN_ARCHS + SCALE_ARCHS + GEMMA_ARCHS + LAYERNORM_ARCHS
               + POSITION_ARCHS + AS_IS_ARCHS + LEAD_BIAS_ARCHS + MLA_ARCHS + GATEUP_SWA_ARCHS
               + SINK_ARCHS + IROPE_ARCHS + MOE_FAMILY_ARCHS + PLE_ARCHS + PLE_ARCHS_NO_SNAPSHOT
               + SINGLE_ARCHS + ["llama", "mixtral", "qwen3moe", "qwen2moe", "deepseek2"]
               ) == set(ARCH_REGISTRY)
    for arch, row in ARCH_REGISTRY.items():
        assert row == JREG[arch], arch


@pytest.mark.parametrize("arch", FLAG_ARCHS + PLAIN_ARCHS + SCALE_ARCHS + GEMMA_ARCHS
                         + AS_IS_ARCHS + LEAD_BIAS_ARCHS + MLA_ARCHS + GATEUP_SWA_ARCHS
                         + SINK_ARCHS + IROPE_ARCHS + MOE_FAMILY_ARCHS + PLE_ARCHS
                         + SINGLE_ARCHS)
def test_arch_snapshot(arch, tmp_path):
    """tests/snapshots/{arch}.npz (the JAX package's golden, from
    build_arch_gguf(seed=11), or build_deepseek2_gguf(seed=11) for the MLA
    rows as tests/test_arch_snapshots.py:44-49 builds them: Q8_0 at n_embd
    64 or 128, so planar weights) through the port's loader and engine on
    the CPU in f32, with the bar of tests/test_arch_snapshots.py:69-73; the
    dense singles with every greedy token the snapshot's. bitnet's snapshot
    is the JAX package's run of a file whose per-tensor scales its loader
    keeps as F32 weights and its forward never reads (ROADMAP §3), so the
    port, which applies them as llama.cpp does, is held to it with each
    scale at 1; tests/test_torch_dense_singles.py holds the scales against
    the JAX forward fed them as the arrays its code reads."""
    path = str(tmp_path / f"{arch}.gguf")
    if arch in ("minicpm3", "mistral4"):
        build_deepseek2_gguf(path, arch, seed=11)
    elif arch == "plm":
        build_deepseek2_gguf(path, arch, seed=11, q_lora=0, gated=False)
    else:
        build_arch_gguf(path, arch, seed=11)
    cfg, params, _ = load_model(path, device="cpu")
    assert cfg.arch == arch
    if arch == "bitnet":
        layers = params["layers"]
        assert all(not torch.all(layers[k] == 1) for k in SCALE_KEYS)
        params = dict(params, layers={k: torch.ones_like(v) if k in SCALE_KEYS else v
                                      for k, v in layers.items()})
    eng = InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                          decode_chunk=4, device="cpu")
    r = eng.generate([[3, 9, 4, 17, 6]], max_new_tokens=8, return_logits=True)
    snap = np.load(os.path.join(SNAP_DIR, f"{arch}.npz"))
    nmse = _nmse(np.asarray(r.logits[0], np.float32), snap["logits"])
    assert nmse < 1e-6, (arch, nmse)
    assert (np.asarray(r.tokens[0]) == snap["tokens"]).mean() >= (
        1.0 if arch in SINGLE_ARCHS else 0.75)


@pytest.fixture(scope="module")
def kmajor_models(tmp_path_factory):
    """{arch: (path, JAX result of PROMPTS)}: each arch at K-major widths,
    Q4_K, generated once by the JAX engine."""
    out = {}
    d = tmp_path_factory.mktemp("arch_flags")
    for arch in KMAJOR_ARCHS:
        path = str(d / f"{arch}.gguf")
        build_arch_gguf(path, arch, n_embd=512, n_head=4, n_head_kv=2, n_ff=512,
                        qtype=GGMLType.Q4_K, seed=11)
        jcfg, jparams, _ = jload(path)
        jr = JEngine(jcfg, jparams, max_seq_len=64, compute_dtype=jnp.float32,
                     decode_chunk=4).generate(PROMPTS, max_new_tokens=8, return_logits=True)
        out[arch] = (path, jcfg, jparams, jr)
    return out


@pytest.mark.parametrize("via", ["loader", "params_from_numpy"])
@pytest.mark.parametrize("arch", KMAJOR_ARCHS)
def test_kmajor_generate_matches_jax(kmajor_models, arch, via):
    """First-step logits at NMSE < 1e-6 and identical greedy tokens (both
    sides run the plain f32 path), the weights K-major and fused as the
    kernels take them."""
    path, jcfg, jparams, jr = kmajor_models[arch]
    if via == "loader":
        cfg, params, _ = load_model(path, device="cpu")
    else:
        cfg, params = params_from_numpy(dataclasses.asdict(jcfg), _flatten(jparams),
                                        device="cpu")
    fields = lambda c: {k: v for k, v in dataclasses.asdict(c).items() if k != "raw_kv"}
    assert fields(cfg) == fields(jcfg)
    layers = params["layers"]
    assert layers.get("wqkv", layers.get("wqkv_cat")).layout == "kmajor"
    r = InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                        decode_chunk=4, device="cpu").generate(
        PROMPTS, max_new_tokens=8, return_logits=True)
    nmse = _nmse(r.logits, jr.logits)
    assert nmse < 1e-6, nmse
    assert r.tokens == jr.tokens


# -------------------------------------------------------------------- server

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
@pytest.mark.parametrize("arch", ["qwen3", "qwen2"])
def test_server_context_matches_jax(kmajor_models, arch, kv):
    """Identical greedy tokens and prefix reuse from the port's and the JAX
    package's ServerContext (token ids, f32 compute, 2 slots, decode chunks
    of 4, prefill chunks of 8 so the longer prompts take two)."""
    path, jcfg, jparams, _ = kmajor_models[arch]
    cfg, params, _ = load_model(path, device="cpu")
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


# --------------------------------------------------------------------- gates

# (use_block, use_fold) of a decode step (B = 4, T = 1) on the card, written
# out: qwen3 and hunyuan-dense decode on the layer kernel, folded (their QK
# norm runs in attention on the rows the kernel emits); the bias archs
# (qwen2, qwen) and the flat-norm arch (olmo2) do not; the post-norm archs
# (glm4, exaone4, olmo2, gemma2, gemma3) fail the kernel's own gate
# (post_norms), and the no-pre-norm archs (exaone4, olmo2) have no ffn_norm;
# gemma v1 takes it with gelu; granite and minicpm at the synth's residual
# scale of 1 take it (test_layer_kernel_off_scaled_residuals holds the rest);
# llama4's dense synth file takes the block but not the fold (its NoPE layer,
# llama.py:1422).
GATES = {"qwen3": (True, True), "hunyuan-dense": (True, True), "maincoder": (True, True),
         "qwen2": (False, False), "qwen": (False, False), "glm4": (False, False),
         "exaone4": (False, False), "olmo2": (False, False), "mistral": (True, True),
         "seed_oss": (True, True), "gemma": (True, True), "gemma2": (False, False),
         "gemma3": (False, False), "granite": (True, True), "minicpm": (True, True),
         "llama4": (True, False)}


@pytest.mark.parametrize("arch", sorted(GATES))
def test_layer_kernel_gates_match_jax(arch, tmp_path):
    """The port's decode-block and fold choices (layer_routes) equal the
    table above and the JAX package's conditions (llama.py:1382-1423, with
    the TPU backend taken as present), evaluated on the JAX package's own
    params of the same GGUF; a prefill (T = 512) and the CPU take neither."""
    path = str(tmp_path / f"{arch}.gguf")
    build_arch_gguf(path, arch, n_embd=512, n_head=4, n_head_kv=2, n_ff=512,
                    qtype=GGMLType.Q4_K, seed=11)
    jcfg, jparams, _ = jload(path)
    jgl = jparams["layers"]
    jqw = {k: v for k, v in jgl.items() if isinstance(v, JQTensor)}
    j_block = ("ffn_norm" in jgl and "ffn_norm_b" not in jgl
               and not any(k in jgl for k in ("bo", "ffn_up_b", "ffn_down_b", "ffn_gate_b",
                                               "attn_norm_2"))
               and not jcfg.attn_bias and not jcfg.attn_qk_norm_flat
               and jcfg.kv_lora_rank == 0 and not jcfg.altup_n
               and not any(k.startswith("lora_") for k in jgl)
               and jblock_supported(jcfg, jqw))
    j_fold = (j_block and "wqkv" in jqw and "attn_norm" in jgl
              and not jcfg.no_rope_interval)
    cfg, params, _ = load_model(path, device="cpu")
    gl = params["layers"]
    qw = {k: v for k, v in gl.items() if isinstance(v, QTensor)}
    assert layer_routes(cfg, gl, qw, 4, 1, True, 1) == GATES[arch] == (j_block, j_fold)
    assert layer_routes(cfg, gl, qw, 1, 512, True, 1) == (False, False)
    assert layer_routes(cfg, gl, qw, 4, 1, False, 1) == (False, False)


@pytest.mark.parametrize("arch", ["granite", "minicpm", "granitemoe"])
def test_layer_kernel_off_scaled_residuals(arch, tmp_path):
    """A residual_scale other than 1 keeps a decode layer off the layer
    kernel, which adds its residuals unscaled. This departs from the JAX
    gate, which does not ask (the TPU's decode would drop the scale there:
    ROADMAP "Known weak spots of the reference"); granitemoe's MoE layers
    take neither."""
    path = str(tmp_path / f"{arch}.gguf")
    build_arch_gguf(path, arch, n_embd=512, n_head=4, n_head_kv=2, n_ff=512,
                    qtype=GGMLType.Q4_K, seed=11)
    cfg, params, _ = load_model(path, device="cpu")
    gl = params["layers"]
    qw = {k: v for k, v in gl.items() if isinstance(v, QTensor)}
    jcfg, jparams, _ = jload(path)
    jqw = {k: v for k, v in jparams["layers"].items() if isinstance(v, JQTensor)}
    scaled = dataclasses.replace(cfg, residual_scale=0.25)
    jscaled = dataclasses.replace(jcfg, residual_scale=0.25)
    moe = arch == "granitemoe"
    assert cfg.residual_scale == (0.5 if moe else 1.0)
    assert layer_routes(scaled, gl, qw, 4, 1, True, 1) == (False, False)
    assert jblock_supported(jscaled, jqw) == (not moe)


# ----------------------------------------------------- refusals and the synths

@pytest.mark.parametrize("extra", ["bias", "qk_norm", "post_norm"])
def test_unread_flag_tensor_raises(tmp_path, monkeypatch, extra):
    """A llama GGUF carrying flag tensors its arch's config never reads
    raises in forward (the JAX package would ignore them)."""
    from tpullm.gguf.writer import GGUFWriter

    write = GGUFWriter.write
    sizes = {"bias": {"attn_q.bias": 512, "attn_k.bias": 256, "attn_v.bias": 256},
             "qk_norm": {"attn_q_norm.weight": 128, "attn_k_norm.weight": 128},
             "post_norm": {"post_attention_norm.weight": 512, "post_ffw_norm.weight": 512}}

    def write_extra(self):
        for name, n in sizes[extra].items():
            self.add_tensor(f"blk.0.{name}", np.ones(n, np.float32))
        return write(self)

    monkeypatch.setattr(GGUFWriter, "write", write_extra)
    path = build_llama_gguf(str(tmp_path / "m.gguf"), vocab_size=256, n_embd=512, n_layer=1,
                            n_head=4, n_head_kv=2, n_ff=512, qtype=GGMLType.Q4_K, seed=1)
    cfg, params, _ = load_model(path, device="cpu")
    cache = KVCache.create(cfg, 1, 16, torch.float32, "cpu")
    tok = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="reads none of them"):
        forward(params, cfg, tok, tok, cache, 0, torch.zeros(1, dtype=torch.int64),
                torch.float32)


@pytest.mark.parametrize("arch", ["qwen3", "qwen2"])
def test_synth_arch_flags(arch):
    """synth_kmajor_q4k_fast with an arch: the row's flags and tensors, the
    other draws as the llama synth's, logits vocab_size wide with
    exact_vocab, and a forward on the CPU that the flag tensors change."""
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    kw = dict(vocab_size=300, n_embd=256, n_layer=2, n_head=2, n_head_kv=1, n_ff=512,
              seed=3, centred=True, device="cpu")
    cfg, params = synth_kmajor_q4k_fast(arch=arch, rope_base=1e6, rms_eps=1e-6,
                                        exact_vocab=True, **kw)
    _, base = synth_kmajor_q4k_fast(**kw)
    assert (cfg.arch, cfg.rope_type, cfg.rope_base, cfg.rms_eps) == (arch, "neox", 1e6, 1e-6)
    layers = params["layers"]
    flag = {"qwen3": ("attn_qk_norm", {"q_norm": 128, "k_norm": 128}),
            "qwen2": ("attn_bias", {"bq": 256, "bk": 128, "bv": 128})}[arch]
    assert getattr(cfg, flag[0])
    assert {k: v.shape for k, v in layers.items() if k in flag[1]} == {
        k: (2, n) for k, n in flag[1].items()}
    for k, v in base["layers"].items():
        if isinstance(v, QTensor):
            assert all(torch.equal(a, layers[k].data[n]) for n, a in v.data.items()), k
    assert params["output"].shape == (300, 256) and base["output"].shape == (512, 256)
    tok = torch.tensor([[3, 9, 4, 17]])
    pos = torch.arange(4)[None]
    vf = torch.zeros(1, dtype=torch.int64)

    def run(c, p):
        cache = KVCache.create(c, 1, 16, torch.float32, "cpu")
        return forward(p, c, tok, pos, cache, 0, vf, torch.float32)[0]

    lg = run(cfg, params)
    assert lg.shape == (1, 4, 300) and torch.isfinite(lg).all()
    bare = dict(params, layers={k: v for k, v in layers.items() if k not in flag[1]})
    lg_bare = run(dataclasses.replace(cfg, **{flag[0]: False}), bare)
    assert _nmse(lg_bare, lg) > 1e-4


def test_qwen2_synth_vocab_and_template():
    """synth_bpe_vocab's Qwen2 layout: 151643 ordinary ids, then
    <|endoftext|>, <|im_start|>, <|im_end|> (EOS and EOT) and reserved ids
    to 151936; pre-type qwen2, no BOS added; specials parse to one id each;
    the ChatML template renders through the port's Jinja as through the JAX
    package's, with the default system turn."""
    from tpullm.server.jinja import render_chat_template as jrender
    from tpullm_torch.server.jinja import render_chat_template as render
    from tpullm_torch.tokenizer import Tokenizer
    from tpullm_torch.utils.synth import synth_bpe_vocab

    v = synth_bpe_vocab(151936, layout="qwen2")
    assert len(v.tokens) == 151936 and v.pre == "qwen2" and not v.add_bos
    assert v.tokens[151643:151646] == ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
    assert (v.bos_id, v.eos_id, v.eot_id) == (151643, 151645, 151645)
    assert v.is_eog(151645) and not v.is_eog(151644)
    tok = Tokenizer(v)
    ids = tok.encode("<|im_start|>user\nhello world<|im_end|>", add_special=True,
                     parse_special=True)
    assert ids[0] == 151644 and ids[-1] == 151645 and max(ids[1:-1]) < 151643
    msgs = [{"role": "user", "content": "Hi there"}]
    text = render(v.chat_template, msgs)
    assert text == ("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
                    "<|im_start|>user\nHi there<|im_end|>\n<|im_start|>assistant\n")
    assert text == jrender(v.chat_template, msgs)
