"""What the port's slices do not cover raises instead of being ignored:
config flags outside the dense llama and MoE paths, other archs, tensors
those paths do not read, weight types and cache types not ported yet."""
import dataclasses

import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGMLType
from tpullm.gguf.writer import GGUFWriter
from tpullm.utils.synth import build_llama_gguf
from tpullm_torch.models.config import ModelConfig, config_from_gguf
from tpullm_torch.models.llama import KVCache, check_dense, forward
from tpullm_torch.ops.qtensor import qtensor_from_bytes
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.tokenizer import Tokenizer, Vocab

torch.set_num_threads(2)


@pytest.mark.parametrize("field,value", [
    ("xielu", ((0.8, 0.8, 0.5, -1e-6),)), ("hybrid_graph", True), ("n_expert", 8),
    ("n_expert_shared", 2), ("diffusion", True), ("mrope_sections", (16, 24, 24, 0)),
    ("attn_out_gate", True),
    ("qk_norm_type", "layernorm"), ("act_fn", "xielu"), ("wkv_head_size", 64),
    ("full_attn_interval", 4), ("ssm_d_conv", 4), ("n_rel_attn_bkts", 32)])
def test_flag_outside_dense_path_raises(field, value):
    """Every field outside the covered paths raises on the dense path. (The
    iRoPE fields, llama4's chunk and smallthinker's dense-first pattern
    pass since the port runs them: tests/test_torch_irope.py; so do the
    per-layer-embedding Gemmas' fields: test_gemma_fields_pass. The hybrid
    walker and M-RoPE's sections take their cases. The dense singles' fields
    raise off their blocks: xIELU's parameters without the ungated xIELU FFN,
    the layernorm QK norm without a per-head QK norm before RoPE, an xIELU
    act_fn on the gated FFN; bitnet's sub_norms pass on the dense block, so
    RWKV's head size takes its case: tests/test_torch_dense_singles.py.)"""
    cfg = ModelConfig()
    check_dense(cfg)
    with pytest.raises(NotImplementedError, match=field):
        check_dense(dataclasses.replace(cfg, **{field: value}))


def test_gemma_fields_pass():
    """gemma4's attention, the per-layer token stream, the shared-KV layers
    and gemma3n's AltUp with its sparsity pass check_dense (the port runs
    them: tests/test_torch_gemma_ple.py)."""
    check_dense(ModelConfig(n_layer=6, gemma4_attn=True, n_embd_per_layer=256,
                            n_layer_kv_from_start=4))
    check_dense(ModelConfig(n_layer=25, gemma4_attn=True, n_embd_per_layer=256,
                            n_layer_kv_from_start=20, altup_n=4, n_layer_sparsity=10))


MIXTRAL = ModelConfig(arch="mixtral", n_expert=8, n_expert_used=2, expert_weights_norm=True)


@pytest.mark.parametrize("field,value", [
    ("moe_dense_parallel", "nemotron"), ("n_group_experts", 3), ("act_fn", "relu2"),
    ("moe_every_n", 2), ("sub_norms", True), ("qk_norm_type", "layernorm"),
    ("n_expert_used", 9), ("expert_gating", "softmax_weight")])
def test_flag_outside_moe_path_raises(field, value):
    """The MoE fields pass only with MoE tensors (moe=True); the other MoE
    features still raise: a dense-beside-MoE block other than grok's and
    arctic's, a chunk group size that does not divide the experts, ungated
    relu^2 experts (nemotron_h_moe), bitnet's sub-norms (the dense block's
    alone), chameleon's layernorm QK norm without a per-head QK norm. (The dense lead's count passes since the port
    runs leading dense layers: test_dense_lead_passes_with_moe_only; so does
    the shared experts' count, whose width the shared expert's tensors
    carry, smallthinker's router input, moe_router_pre_norm, grovemoe's
    chunk experts, grok's GELU experts and grok's and arctic's blocks:
    tests/test_torch_moe_families.py.)"""
    check_dense(MIXTRAL, moe=True)
    with pytest.raises(NotImplementedError, match="n_expert|MoE|" + field):
        check_dense(dataclasses.replace(MIXTRAL, **{field: value}), moe=True)


def _gguf(tmp_path, **kw):
    path = str(tmp_path / "m.gguf")
    base = dict(vocab_size=256, n_embd=512, n_layer=1, n_head=4, n_head_kv=2, n_ff=512,
                qtype=GGMLType.Q4_K, seed=1)
    base.update(kw)
    return build_llama_gguf(path, **base)


def test_dense_lead_passes_with_moe_only():
    """n_layer_dense_lead is a MoE field: it passes beside MoE tensors and
    raises on the dense decoder path."""
    check_dense(dataclasses.replace(MIXTRAL, n_layer_dense_lead=1), moe=True)
    with pytest.raises(NotImplementedError, match="n_layer_dense_lead"):
        check_dense(ModelConfig(n_layer_dense_lead=1))


class _Meta:
    """The metadata face of a GGUFFile: all config_from_gguf reads."""

    def __init__(self, metadata, arch="llama"):
        self.metadata = {"general.architecture": arch, **metadata}
        self.architecture = arch

    def get(self, key, default=None):
        return self.metadata.get(key, default)


def test_dense_keys_parse():
    cfg = config_from_gguf(_Meta({"llama.embedding_length": 512, "llama.attention.head_count": 4,
                                  "llama.rope.scaling.type": "linear",
                                  "llama.rope.scaling.factor": 2.0, "general.name": "x",
                                  "tokenizer.ggml.tokens": ["a"] * 300}))
    assert (cfg.n_embd, cfg.head_dim, cfg.vocab_size) == (512, 128, 300)
    assert (cfg.rope_scaling, cfg.rope_scale, cfg.rope_type) == ("linear", 2.0, "norm")
    check_dense(cfg)


@pytest.mark.parametrize("key,value", [
    ("llama.expert_group_scale", 2.0), ("llama.feed_forward_length", [512, 256]),
    ("llama.attention.head_count", np.array([4, 4, 8])),
    ("llama.rope.scaling.finetuned", True),
    ("llama.attention.shared_kv_layers", 2), ("xielu.alpha_n", [0.8]),
    ("llama.rope.dimension_sections", [16, 24, 24, 0]), ("llama.pooling_type", 1),
    ("llama.experts_per_group", 2)])
def test_gguf_key_outside_dense_path_raises(key, value):
    with pytest.raises(NotImplementedError, match=key):
        config_from_gguf(_Meta({key: value}))


@pytest.mark.parametrize("arch,key,value", [
    ("qwen2vl", "rope.dimension_sections", [16, 24, 24, 0]),
    ("qwen3vl", "rope.dimension_sections", [24, 20, 20, 0]),
    ("hunyuan_vl", "rope.dimension_sections", [16, 24, 24, 0]),
    ("llama-embed", "pooling_type", 1), ("kimi-linear", "kda.head_dim", 128),
    ("kimi-linear", "ssm.conv_kernel", 4)])
def test_new_rows_keep_their_refusals(arch, key, value):
    """The rows that run as they are still refuse what they carry beyond
    the covered paths: M-RoPE's sections (text positions reduce to neox;
    the image grid's do not), llama-embed's pooled output, kimi-linear's
    KDA keys (its head dim, its convolution's width)."""
    with pytest.raises(NotImplementedError, match=key):
        config_from_gguf(_Meta({f"{arch}.{key}": value}, arch))


@pytest.mark.parametrize("arch,key", [("nemotron_h_moe", "nemotron_h_moe.expert_count"),
                                      ("lfm2moe", "lfm2moe.expert_count"),
                                      ("llada-moe", "llada-moe.expert_count")])
def test_unported_moe_archs_raise(arch, key):
    """The MoE rows of the hybrid and diffusion families stay out of the
    registry (nemotron_h_moe's FFN-only and recurrent layers, lfm2moe's
    short convolutions, llada-moe's diffusion decoding): a file of theirs
    raises at the arch gate, whatever its keys. (afmoe and smallthinker run:
    tests/test_torch_irope.py; dbrx, grok, arctic and grovemoe:
    tests/test_torch_moe_families.py.)"""
    with pytest.raises(NotImplementedError, match=arch):
        config_from_gguf(_Meta({key: 4}, arch))


def test_afmoe_attention_gate_tensors_raise(tmp_path):
    """An afmoe file loads: its post-norm names (attn_post_norm,
    ffn_post_norm) as the post-norms, its attention gate as wide as the
    attention output as wqkv_gate, and its forward runs. A gate of another
    width (here the per-head gate's n_head rows cut to n_head - 1) still
    raises in forward, naming both widths the port runs."""
    from tpullm.utils.synth import build_arch_gguf

    path = str(tmp_path / "afmoe.gguf")
    build_arch_gguf(path, "afmoe", seed=11)
    cfg, params = load_model(path, device="cpu")[:2]
    groups = params["layers"]["__groups__"]
    for gl in groups:
        assert {"post_attn_norm", "post_ffn_norm"} <= set(gl)
        assert gl["wqkv_gate"].n_out == cfg.n_head * cfg.head_dim_v
    assert torch.isfinite(_forward(cfg, params)[0]).all()
    gate = groups[1]["wqkv_gate"]
    groups[1]["wqkv_gate"] = type(gate)(gate.qtype, (1, cfg.n_head - 1, cfg.n_embd),
                                        dict(gate.data))
    with pytest.raises(NotImplementedError, match=f"wqkv_gate.*{cfg.n_head} rows.*"
                                                  f"{cfg.n_head * cfg.head_dim_v} rows"):
        _forward(cfg, params)


def _kimi_gguf(tmp_path, monkeypatch, extra):
    """kimi-linear's arch snapshot GGUF (the dense layers it shares with
    llama) with ``extra`` {name: f32 array} tensors."""
    from tpullm.utils.synth import build_arch_gguf

    write = GGUFWriter.write

    def write_extra(self):
        for name, arr in extra.items():
            self.add_tensor(name, arr)
        return write(self)

    monkeypatch.setattr(GGUFWriter, "write", write_extra)
    return build_arch_gguf(str(tmp_path / "kimi.gguf"), "kimi-linear", seed=11)


@pytest.mark.parametrize("name,shape", [
    ("blk.0.ssm_conv1d_q.weight", (64, 1, 4)), ("blk.0.ssm_f_a.weight", (16, 64)),
    ("blk.0.ssm_beta.weight", (4, 64)), ("blk.0.ssm_norm.weight", (16,)),
    ("blk.1.attn_kv_a_mqa.weight", (80, 64)), ("blk.1.attn_k_b.weight", (4, 64, 48)),
    ("blk.1.attn_kv_a_norm.weight", (64,))])
def test_kimi_linear_kda_and_mla_tensors_raise(tmp_path, monkeypatch, name, shape):
    """kimi-linear's row runs its llama-shaped layers, but the tensors of
    its KDA and MLA layers raise at load as outside the covered paths."""
    path = _kimi_gguf(tmp_path, monkeypatch, {name: np.zeros(shape, np.float32)})
    with pytest.raises(NotImplementedError, match=name.split(".")[2]):
        load_model(path, device="cpu")


def test_kimi_linear_file_raises(tmp_path):
    """A kimi-linear file with its KDA and MLA layers (per-layer kv head
    counts, the KDA and MLA keys) raises at load."""
    from tpullm.utils.synth import build_kimi_linear_gguf

    path = build_kimi_linear_gguf(str(tmp_path / "kimi.gguf"), pattern="kkak", seed=5)
    with pytest.raises(NotImplementedError):
        load_model(path, device="cpu")


@pytest.mark.parametrize("pattern", ["kkak", "aaaa"])
def test_kimi_linear_mla_layers_raise_with_kda(tmp_path, pattern):
    """MLA is ported, but a kimi-linear file still raises, with only its
    rope-less MLA layers too: its KDA keys come with every file, and its
    per-layer kv head counts (1 on an MLA layer, 0 on a KDA one) are not on
    the covered paths."""
    from tpullm.utils.synth import build_kimi_linear_gguf

    path = build_kimi_linear_gguf(str(tmp_path / "kimi.gguf"), pattern=pattern, seed=5)
    with pytest.raises(NotImplementedError, match="kda.head_dim"):
        load_model(path, device="cpu")
    with pytest.raises(NotImplementedError, match="head_count_kv"):
        config_from_gguf(_Meta({"kimi-linear.attention.head_count_kv": np.array([1, 0]),
                                "kimi-linear.attention.kv_lora_rank": 512}, "kimi-linear"))


def _glm_dsa_gguf(tmp_path, monkeypatch, arch="glm-dsa", extra=None):
    """A glm-dsa-shaped MLA MoE file with the DSA indexer's tensors
    (build_deepseek2_gguf's indexer), under ``arch``, with ``extra`` {name:
    f32 array} tensors."""
    from tpullm.utils.synth import build_deepseek2_gguf

    write = GGUFWriter.write

    def write_extra(self):
        for name, arr in (extra or {}).items():
            self.add_tensor(name, arr)
        return write(self)

    monkeypatch.setattr(GGUFWriter, "write", write_extra)
    return build_deepseek2_gguf(str(tmp_path / "dsa.gguf"), arch, moe=True, split_mla=True,
                                indexer=(2, 16, 8), seed=3)


def test_glm_dsa_indexer_is_the_only_extra(tmp_path, monkeypatch):
    """glm-dsa's indexer tensors (and its attention.indexer.* keys) are the
    only names the port passes over unread, as the JAX loader leaves them:
    the file loads and runs; one more indexer-like name raises; the same
    indexer tensors on a deepseek2 file raise, and so do its keys."""
    cfg, params, _ = load_model(_glm_dsa_gguf(tmp_path, monkeypatch), device="cpu")
    assert cfg.kv_lora_rank == 64 and cfg.expert_gating == "sigmoid"
    assert not any("indexer" in k for gl in params["layers"]["__groups__"] for k in gl)
    cache = KVCache.create(cfg, 1, 16, torch.float32, "cpu")
    tok = torch.zeros((1, 4), dtype=torch.int64)
    logits, _ = forward(params, cfg, tok, torch.arange(4)[None], cache, 0,
                        torch.zeros(1, dtype=torch.int64), torch.float32)
    assert torch.isfinite(logits).all()
    extra = {"blk.0.indexer.k_proj.weight": np.zeros((16, 128), np.float32)}
    with pytest.raises(NotImplementedError, match="indexer.k_proj"):
        load_model(_glm_dsa_gguf(tmp_path, monkeypatch, extra=extra), device="cpu")
    with pytest.raises(NotImplementedError, match="indexer"):
        load_model(_glm_dsa_gguf(tmp_path, monkeypatch, arch="deepseek2"), device="cpu")


def test_planar_q5_0_raises():
    """Planar Q5_1 at K 1408 and 10944 (the rows where a Q4_K_M
    DeepSeek-V2-Lite file falls back to Q5_0) has no K-major tile there and
    is not ported: it raises. (Planar Q5_0 itself loads since it is ported:
    tests/test_torch_moe_families.py::test_planar_q5_0_bit_exact.)"""
    for K in (1408, 10944):
        with pytest.raises(NotImplementedError, match="Q5_1"):
            qtensor_from_bytes(np.zeros(24 * K // 32 * 2, np.uint8), GGMLType.Q5_1, (2, K))


def test_selection_bias_on_dense_layer_raises(tmp_path, monkeypatch):
    """The router's selection bias loads as moe_probs_b, but a layer
    without routed experts reads none: forward raises."""
    write = GGUFWriter.write

    def write_extra(self):
        self.add_tensor("blk.0.exp_probs_b.bias", np.zeros(4, np.float32))
        return write(self)

    monkeypatch.setattr(GGUFWriter, "write", write_extra)
    cfg, params, _ = load_model(_gguf(tmp_path), device="cpu")
    assert params["layers"]["moe_probs_b"].dtype == torch.float32
    cache = KVCache.create(cfg, 1, 16, torch.float32, "cpu")
    tok = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="moe_probs_b"):
        forward(params, cfg, tok, tok, cache, 0, torch.zeros(1, dtype=torch.int64),
                torch.float32)


def test_per_layer_head_counts_raise():
    with pytest.raises(NotImplementedError, match="head_count_kv"):
        config_from_gguf(_Meta({"llama.attention.head_count_kv": np.array([4, 0])}))


def test_other_arch_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="mamba"):
        load_model(_gguf(tmp_path, arch="mamba"), device="cpu")


def test_swa_array_is_the_only_per_layer_key():
    """The SWA pattern loads as a per-layer array; every other per-layer
    array still raises, the SWA pattern's beside it too."""
    cfg = config_from_gguf(_Meta({"llama.attention.sliding_window": 64, "llama.block_count": 2,
                                  "llama.attention.sliding_window_pattern": [1, 0]}))
    assert cfg.swa_layer_pattern == (True, False) and cfg.swa_pattern == 2
    check_dense(cfg)
    for key in ("attention.head_count_kv", "feed_forward_length", "attention.key_length",
                "rope.freq_base"):
        with pytest.raises(NotImplementedError, match=key):
            config_from_gguf(_Meta({"llama.block_count": 2, f"llama.{key}": [8, 4],
                                    "llama.attention.sliding_window_pattern": [1, 0]}))


def _layers(tmp_path, **kw):
    """A 2-layer llama file loaded on the CPU: (cfg, params)."""
    cfg, params, _ = load_model(_gguf(tmp_path, n_layer=2, **kw), device="cpu")
    return cfg, params


def _forward(cfg, params):
    cache = KVCache.create(cfg, 1, 16, torch.float32, "cpu")
    tok = torch.zeros((1, 4), dtype=torch.int64)
    return forward(params, cfg, tok, torch.arange(4)[None], cache, 0,
                   torch.zeros(1, dtype=torch.int64), torch.float32)


@pytest.mark.parametrize("layout", ["up_only", "no_down", "no_ffn"])
def test_ffn_without_a_gate_layout_raises(tmp_path, layout):
    """A gated FFN with neither of its layouts (separate or fused gate and
    up, or a GGUF-combined [gate; up] of 2 x n_ff rows), or without its
    down, raises NotImplementedError naming the tensors, not a bare
    KeyError."""
    cfg, params = _layers(tmp_path)
    layers = params["layers"]
    gu = layers.pop("ffn_gateup")
    if layout == "up_only":  # the gate half alone, n_ff rows: no gate layout
        layers["ffn_up"] = type(gu)(gu.qtype, (2, cfg.n_ff, cfg.n_embd),
                                    {k: v[..., :cfg.n_ff] for k, v in gu.data.items()})
    elif layout == "no_down":
        layers["ffn_gateup"] = gu
        del layers["ffn_down"]
    with pytest.raises(NotImplementedError, match="FFN tensors") as e:
        _forward(cfg, params)
    assert ("'ffn_up': (2, 512, 512)" in str(e.value)) == (layout == "up_only")


def test_full_width_attention_gate_raises(tmp_path):
    """The attention output gate runs per head (step35) or as wide as the
    attention output (afmoe's, n_head x head_dim rows: here wo's arrays,
    512 rows); a gate of any other width (256 rows) raises in forward,
    naming it."""
    import dataclasses as dc

    cfg, params = _layers(tmp_path)
    cfg = dc.replace(cfg, attn_gate_proj=True)
    wide = params["layers"]["wo"]  # (L, n_embd, n_head * head_dim) = (2, 512, 512)
    params["layers"]["wqkv_gate"] = type(wide)(wide.qtype, wide.shape, dict(wide.data))
    assert torch.isfinite(_forward(cfg, params)[0]).all()
    params["layers"]["wqkv_gate"] = type(wide)(wide.qtype, (2, 256, 512), dict(wide.data))
    with pytest.raises(NotImplementedError, match="wqkv_gate"):
        _forward(cfg, params)
    del params["layers"]["wqkv_gate"]
    assert torch.isfinite(_forward(cfg, params)[0]).all()
    with pytest.raises(NotImplementedError, match="wqkv_gate"):  # and none without the flag
        params["layers"]["wqkv_gate"] = type(wide)(wide.qtype, (2, 4, 512), dict(wide.data))
        _forward(dc.replace(cfg, attn_gate_proj=False), params)


def test_mimo2_value_scale_raises(tmp_path):
    """mimo2's file, once refused at the key gate on attention.value_scale,
    now loads and runs: the scale parses into attn_out_scale (0.9 in the
    synth) beside its SWA array, its sinks and its sigmoid MoE with the
    selection bias, as the JAX parser reads them; a value scale on an MLA
    config still raises (the JAX MLA branch does not read it). Its logits
    against the JAX package: tests/test_torch_arch_flags.py and
    tests/test_torch_sinks.py."""
    from tpullm.runtime.loader import load_model as jload
    from tpullm.utils.synth import build_arch_gguf

    path = build_arch_gguf(str(tmp_path / "mimo2.gguf"), "mimo2", n_layer=4, seed=11)
    cfg, params, _ = load_model(path, device="cpu")
    jcfg = jload(path)[0]
    assert cfg.attn_out_scale == jcfg.attn_out_scale == pytest.approx(0.9)
    assert cfg.swa_layer_pattern == jcfg.swa_layer_pattern and cfg.expert_gating == "sigmoid"
    assert {"attn_sinks", "moe_probs_b"} <= set(params["layers"])
    with pytest.raises(NotImplementedError, match="attn_out_scale"):
        check_dense(ModelConfig(kv_lora_rank=64, rope_dim=32, head_dim=64, attn_out_scale=0.9))


def test_unread_tensor_raises(tmp_path, monkeypatch):
    """A tensor no covered path reads raises at load (the sinks, which this
    test named before, now load: tests/test_torch_sinks.py): bitnet's
    attention sub-norm on a llama file."""
    write = GGUFWriter.write

    def write_extra(self):
        self.add_tensor("blk.0.attn_sub_norm.weight", np.ones(512, np.float32))
        return write(self)

    monkeypatch.setattr(GGUFWriter, "write", write_extra)
    with pytest.raises(NotImplementedError, match="attn_sub_norm"):
        load_model(_gguf(tmp_path), device="cpu")


def test_tied_embeddings_load(tmp_path):
    cfg, params, _ = load_model(_gguf(tmp_path, tie_embeddings=True), device="cpu")
    assert cfg.tie_embeddings and params["output"] is params["tok_embd"]


def test_planar_only_weights_raise():
    """Q8_K has no K-major layout; Q4_0 at K=128 is too short for it (the
    planar layout is ported for Q8_0 and Q4_K only)."""
    raw = np.zeros(292 * 4, np.uint8)
    with pytest.raises(NotImplementedError, match="Q8_K"):
        qtensor_from_bytes(raw, GGMLType.Q8_K, (4, 256))
    with pytest.raises(NotImplementedError, match="Q4_0"):
        qtensor_from_bytes(np.zeros(18 * 4 * 4, np.uint8), GGMLType.Q4_0, (4, 128))


def test_int8_kv_cache_raises():
    with pytest.raises(NotImplementedError, match="KV cache"):
        KVCache.create(ModelConfig(), 1, 16, torch.int8, "cpu")


def _moe_gguf(tmp_path, monkeypatch, extra):
    """A 1-layer mixtral GGUF with ``extra`` {name: f32 array} tensors."""
    write = GGUFWriter.write

    def write_extra(self):
        for name, arr in extra.items():
            self.add_tensor(name, arr)
        return write(self)

    monkeypatch.setattr(GGUFWriter, "write", write_extra)
    return _gguf(tmp_path, arch="mixtral", n_expert=4, n_expert_used=2)


@pytest.mark.parametrize("name,shape", [
    ("blk.0.ffn_up_chexps.weight", (2, 512, 512)), ("blk.0.ffn_latent_down.weight", (256, 512)),
    ("blk.0.ffn_latent_up.weight", (512, 256)), ("blk.0.ffn_gate_shexp.weight", (512, 512)),
    ("blk.0.ffn_up_shexp.weight", (512, 512)), ("blk.0.ffn_norm_exps.weight", (512,)),
    ("blk.0.ffn_gate_chexps.weight", (2, 512, 512))])
def test_moe_tensor_outside_path_raises(tmp_path, monkeypatch, name, shape):
    """Partial shared experts, the arctic expert norm, chunk experts and
    nemotron-h's latent projections are not on the covered MoE path: the
    loader raises. (The expert biases and the router's bias, which this test
    named before, now load: test_moe_biases_load_and_run.)"""
    path = _moe_gguf(tmp_path, monkeypatch, {name: np.zeros(shape, np.float32)})
    with pytest.raises(NotImplementedError, match=name.split(".")[1]):
        load_model(path, device="cpu")


@pytest.mark.parametrize("name,shape,key", [
    ("blk.0.ffn_gate_exps.bias", (4, 512), "moe_gate_exps_b"),
    ("blk.0.ffn_down_exps.bias", (4, 512), "moe_down_exps_b"),
    ("blk.0.ffn_gate_inp.bias", (4,), "moe_gate_inp_b")])
def test_moe_biases_load_and_run(tmp_path, monkeypatch, name, shape, key):
    """gpt-oss's expert biases and the router's bias, refused before, load
    as f32 layer tensors beside the routed experts and move the forward's
    logits; a layer without routed experts does not read them, and they
    raise there (_unread_tensors)."""
    from tpullm_torch.models.llama import _unread_tensors

    path = _moe_gguf(tmp_path, monkeypatch, {name: np.full(shape, 0.5, np.float32)})
    cfg, params, _ = load_model(path, device="cpu")
    b = params["layers"][key]
    assert b.dtype == torch.float32 and tuple(b.shape) == (1,) + shape
    tok = torch.tensor([[3, 1, 4, 1, 5]])
    vf = torch.zeros(1, dtype=torch.int64)
    out = []
    for p in (params, dict(params, layers={k: v for k, v in params["layers"].items()
                                            if k != key})):
        cache = KVCache.create(cfg, 1, 16, torch.float32, "cpu")
        out.append(forward(p, cfg, tok, tok, cache, 0, vf, torch.float32)[0])
    assert not torch.allclose(out[0], out[1])
    assert _unread_tensors(ModelConfig(), {key: b, "ffn_down": None}) == [key]


def test_moe_config_and_tensors_go_together(tmp_path, monkeypatch):
    """MoE fields without MoE tensors, and MoE tensors without the full
    set, raise in forward."""
    cfg, params, _ = load_model(_moe_gguf(tmp_path, monkeypatch, {}), device="cpu")
    cache = KVCache.create(cfg, 1, 16, torch.float32, "cpu")
    tok = torch.zeros((1, 4), dtype=torch.int64)
    vf = torch.zeros(1, dtype=torch.int64)
    forward(params, cfg, tok, tok, cache, 0, vf, torch.float32)
    partial = dict(params, layers={k: v for k, v in params["layers"].items()
                                   if k != "moe_up_exps"})
    with pytest.raises(NotImplementedError, match="MoE layers"):
        forward(partial, cfg, tok, tok, cache, 0, vf, torch.float32)
    dense = dict(params, layers={k: v for k, v in params["layers"].items()
                                 if not k.startswith("moe_")})
    with pytest.raises(NotImplementedError, match="n_expert"):
        forward(dense, cfg, tok, tok, cache, 0, vf, torch.float32)


@pytest.fixture(scope="module")
def small_model():
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    return synth_kmajor_q4k_fast(vocab_size=256, n_embd=256, n_layer=1, n_head=2,
                                 n_head_kv=1, n_ff=512, device="cpu")


@pytest.mark.parametrize("option,value", [
    ("lora", [("adapter.gguf", 1.0)]), ("mmproj_path", "mmproj.gguf"), ("spec", "ngram"),
    ("draft", ("cfg", "params")), ("slot_save_path", "slots"),
    ("tokenizer", Vocab(model="t5", tokens=["<pad>", "</s>", "<unk>", "▁a"]))])
def test_server_option_not_ported_raises(small_model, option, value):
    """Every construction option not ported raises. The tokenizer is ported
    for SPM and BPE: one of another family (here t5's UGM) raises as it is
    built for the server."""
    from tpullm_torch.server.context import ServerContext

    cfg, params = small_model
    with pytest.raises(NotImplementedError, match="not ported"):
        if option == "tokenizer":
            value = Tokenizer(value)
        ServerContext(cfg, params, **{option: value}, device="cpu")


@pytest.mark.parametrize("field,value,family", [
    ("arch", "t5", "t5"), ("wkv_head_size", 64, "rwkv"), ("ssm_d_conv", 4, "hybrid"),
    ("hybrid_graph", True, "hybrid")])
def test_server_family_not_ported_raises(small_model, field, value, family):
    from tpullm_torch.server.context import ServerContext

    cfg, params = small_model
    with pytest.raises(NotImplementedError, match=family):
        ServerContext(dataclasses.replace(cfg, **{field: value}), params, device="cpu")


def test_server_iswa_with_swa_layers_raises(small_model):
    """iswa is a no-op without SWA layers and with a window on every layer
    (swa_pattern 1), as in the JAX package; with interleaved SWA layers it
    builds the dual cache, which once raised here (a 1-layer model whose
    layer is SWA: no full bank, a ring of window + prefill_chunk slots) and
    serves; the int8 cache stays full-context."""
    from tpullm_torch.server.context import GenParams, ServerContext

    cfg, params = small_model
    kw = dict(max_seq_len=128, prefill_chunk=16, compute_dtype=torch.float32, device="cpu")
    assert not ServerContext(cfg, params, iswa=True, **kw).memory.cache.dual
    every = dataclasses.replace(cfg, sliding_window=64)
    assert not ServerContext(every, params, iswa=True, **kw).memory.cache.dual
    swa = dataclasses.replace(cfg, sliding_window=64, swa_pattern=2)
    assert not ServerContext(swa, params, iswa=True, kv_dtype="q8", **kw).memory.cache.dual
    ctx = ServerContext(swa, params, iswa=True, **kw)
    cache = ctx.memory.cache
    assert cache.dual and cache.ring == 64 + 16
    assert cache.k.shape[0] == 0 and cache.kw.shape[0] == 1
    ctx.start()
    try:
        assert len(ctx.generate(list(range(1, 100)), GenParams(max_tokens=4))["tokens"]) == 4
    finally:
        ctx.stop()


@pytest.mark.parametrize("request_params,what", [
    (dict(grammar='root ::= "a"'), "grammar"), (dict(json_schema={"type": "object"}),
                                               "json_schema"),
    (dict(infill_sampler=True), "infill"), (dict(grammar_lazy=True), "grammar")])
def test_server_request_not_ported_fails(small_model, request_params, what):
    from tpullm_torch.server.context import GenParams, ServerContext

    cfg, params = small_model
    ctx = ServerContext(cfg, params, max_seq_len=64, compute_dtype=torch.float32, device="cpu")
    ctx.start()
    try:
        with pytest.raises(RuntimeError, match=f"{what}.*not ported"):
            ctx.generate([1, 2, 3], GenParams(max_tokens=2, **request_params))
        assert len(ctx.generate([1, 2, 3], GenParams(max_tokens=2))["tokens"]) == 2
    finally:
        ctx.stop()


@pytest.mark.parametrize("method,args", [
    ("save_slot", (0,)), ("load_slot", (0, {})), ("save_slot_file", (0, "f")),
    ("load_slot_file", (0, "f")), ("save_state", ()), ("load_state", ({},)),
    ("save_state_file", ("f",)), ("load_state_file", ("f",))])
def test_slot_save_restore_raises(small_model, method, args):
    from tpullm_torch.runtime.memory import SlotMemory

    cfg, _ = small_model
    m = SlotMemory(cfg, 2, 32, device="cpu")
    with pytest.raises(NotImplementedError, match="save/restore"):
        getattr(m, method)(*args)


@pytest.mark.parametrize("flag", [["--hf-repo", "org/repo"], ["--lora", "a.gguf"],
                                  ["--mmproj", "p.gguf"], ["--spec", "ngram"],
                                  ["--model-url", "u"], ["--model-draft", "d.gguf"],
                                  ["--slot-save-path", "s"]])
def test_server_cli_flag_not_ported_raises(flag):
    from tpullm_torch.server.__main__ import main

    with pytest.raises(NotImplementedError, match=flag[0]):
        main(["-m", "model.gguf"] + flag)


def test_text_prompt_without_tokenizer_answers_501(small_model):
    import json
    import socket
    import urllib.error
    import urllib.request

    from tpullm_torch.server.context import ServerContext
    from tpullm_torch.server.http import serve

    cfg, params = small_model
    ctx = ServerContext(cfg, params, max_seq_len=64, compute_dtype=torch.float32, device="cpu")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    srv = serve(ctx, "127.0.0.1", port, block=False)
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                     json.dumps({"prompt": "hello"}).encode(),
                                     {"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 501
        assert "tokenizer" in json.loads(e.value.read())["error"]["message"]
    finally:
        srv.shutdown()
        srv.server_close()
        ctx.stop()
