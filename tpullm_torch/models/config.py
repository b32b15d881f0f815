"""Model hyperparameters parsed from GGUF metadata.

Copy of tpullm/models/config.py for the PyTorch port. ``ModelConfig`` keeps
every field of the JAX package's (so a config carried across with
``dataclasses.asdict`` round-trips); ``config_from_gguf`` reads only the
keys of the paths the port covers (the dense decoder with the flags its
registry rows set, the routed-expert MoE FFN and MLA, the compressed-KV
attention of the deepseek2 family) and raises on any other key of the arch.
Fields those paths never set are rejected by models/llama.py rather than
ignored.

Counterpart of the reference's hparams loader (src/llama-hparams.h:1-359 +
per-arch KV reads in src/llama-model.cpp). One flat dataclass covers the
transformer families; arch-specific quirks (parallel residual, expert gating,
sliding window patterns) are fields with defaults.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..gguf.reader import GGUFFile


@dataclass
class ModelConfig:
    arch: str = "llama"
    vocab_size: int = 32000
    n_embd: int = 2048
    n_layer: int = 22
    n_head: int = 32
    n_head_kv: int = 4
    head_dim: int = 64  # key_length
    head_dim_v: int = 64
    n_ff: int = 5632
    n_ctx_train: int = 2048
    rms_eps: float = 1e-5
    norm_eps: float = 0.0  # layernorm (non-RMS) archs
    rope_base: float = 10000.0
    rope_dim: int = 64
    rope_type: str = "norm"  # "norm" (interleaved pairs) | "neox" (half split)
    rope_scaling: str = "none"  # none | linear | yarn
    rope_scale: float = 1.0
    rope_orig_ctx: int = 0
    rope_yarn_low: float = 1.0
    rope_yarn_high: float = 4.0
    rope_attn_factor: float = 1.0
    # MoE
    n_expert: int = 0
    n_expert_used: int = 0
    expert_gating: str = "softmax"  # softmax | sigmoid
    expert_weights_norm: bool = False
    expert_weights_scale: float = 1.0
    n_ff_exp: int = 0
    n_expert_shared: int = 0
    # attention details
    sliding_window: int = 0
    swa_pattern: int = 1  # every Nth layer is full-attention (1 = all full)
    swa_layer_pattern: tuple = ()  # explicit per-layer is-SWA flags (mimo2)
    swa_chunked: bool = False  # llama4: chunk-aligned windows, not sliding
    swa_dense_first: bool = False  # smallthinker: layer il%p==0 is dense
    no_rope_offset: int = 1  # (li+offset) % interval == 0 -> no rope
    moe_router_pre_norm: bool = False  # smallthinker: router reads inpL
    # llama4 iRoPE: every Nth layer has NO rope; its Q is temperature-scaled
    no_rope_interval: int = 0
    attn_temp_scale: float = 0.0
    attn_temp_floor: int = 8192
    attn_temp_offset: float = 1.0
    qk_l2_norm: bool = False  # weightless rms over the head dim (rope layers)
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    # per-head q/k norm flavor: chameleon uses LAYERNORM (with bias) over
    # the head dim with PER-HEAD weights (src/models/chameleon.cpp:90-104)
    qk_norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    # apertus xIELU activation: per-layer (alpha_n, alpha_p, beta, eps)
    # AFTER the build-time softplus transform (ggml/src/ggml.c ggml_xielu)
    xielu: tuple = ()
    # dense FFN runs IN PARALLEL with the MoE branch:
    #   "grok":   out = sqrt(2)/2 * (dense(h2) + moe(h2))  (grok.cpp:171-183)
    #   "arctic": out = (dense(h2)+ffn_inp) + moe(norm_exps(x0))  (arctic.cpp)
    moe_dense_parallel: str = ""
    # grovemoe adjugate "chunk" experts: second expert bank indexed by
    # main_expert_id // n_group_experts, same router probs (grovemoe.cpp)
    n_group_experts: int = 0
    expert_group_scale: float = 1.0
    n_ff_chexp: int = 0
    # afmoe: attention output gated by sigmoid(wqkv_gate @ attn_input)
    # BEFORE the output projection (src/models/afmoe.cpp:177-190)
    attn_gate_proj: bool = False
    # bitnet (src/models/bitnet.cpp): RMS sub-norms applied to the
    # attention output BEFORE wo and to the FFN hidden BEFORE down,
    # plus optional per-tensor {1} output scales (wq_s, ffn_up_s, ...)
    sub_norms: bool = False
    # nomic-bert-moe: layer i is MoE iff i %% moe_every_n == 1
    # (src/models/nomic-bert.cpp LLM_KV_MOE_EVERY_N_LAYERS)
    moe_every_n: int = 0
    # encoder symmetric SWA (modern-bert/gemma-embedding): local layers may
    # rope at a different frequency base (LLM_KV_ROPE_FREQ_BASE_SWA)
    rope_base_swa: float = 0.0
    attn_scale: float = 0.0  # 0 -> 1/sqrt(head_dim)
    attn_out_scale: float = 0.0  # mimo2: scale on the attn OUTPUT (post-wo)
    # gemma4/gemma3n: per-layer token-embedding stream width (0 = off)
    n_embd_per_layer: int = 0
    # gemma4/gemma3n: layers >= this REUSE the cache of layer
    # n_kv_from_start - (2 if swa else 1) (llama-model.cpp:2005 reuse cb)
    n_layer_kv_from_start: int = -1
    gemma4_attn: bool = False  # weightless V norm, optional wv (v=k)
    # gemma3n AltUp (src/models/gemma3n.cpp): the residual stream is a
    # STACK of altup_n streams; stream altup_act runs the layer, a
    # router-predicted mix corrects the rest (llama-hparams.h:189-193
    # fixed defaults: n_altup=4, i_altup_act=0)
    altup_n: int = 0
    altup_act: int = 0
    # gemma3n activation sparsity: first N layers relu-cut the FFN gate at
    # mean + std*mul (models.h:735-736 fixed: 10, icdf(0.95))
    n_layer_sparsity: int = 0
    sparsity_std_mul: float = 1.6448533535003662
    clamp_kqv: float = 0.0
    # ALiBi position bias (mpt/bloom/jais/baichuan-13b families): slope_h *
    # (kv_pos - q_pos) added to scores (ggml_soft_max_ext max_bias semantics)
    alibi_max_bias: float = 0.0
    use_rope: bool = True  # gpt2/starcoder/bloom/mpt: no rotary embedding
    # q/k norm over the FLATTENED projection (n_embd rows) instead of
    # per-head (mpt qk_ln, olmoe): build_norm on the 2-D Qcur/Kcur
    attn_qk_norm_flat: bool = False
    logit_scale: float = 1.0  # final logits multiplier (command-r, jais)
    # structure flags
    parallel_residual: bool = False
    residual_scale: float = 1.0  # granite/minicpm f_residual_scale
    tie_embeddings: bool = False
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    act_fn: str = "silu"  # silu | gelu | relu2 | swiglu_oai
    ffn_gate: bool = True  # gated (SwiGLU-style) FFN
    attn_qk_norm: bool = False
    # maincoder (src/models/maincoder.cpp): per-head q/k RMS applied AFTER
    # rope instead of the usual pre-rope placement (qwen3 et al.)
    qk_norm_post_rope: bool = False
    attn_bias: bool = False
    post_norms: bool = False  # gemma-style post-attn/post-ffn norms
    embedding_scale: float = 1.0
    # encoder (BERT-family) models
    causal: bool = True
    pooling_type: str = "none"  # none | mean | cls | last | rank
    n_cls_out: int = 1
    # MLA (deepseek2 family): compressed-KV attention
    q_lora_rank: int = 0
    kv_lora_rank: int = 0  # >0 enables the MLA graph + compressed cache
    n_layer_dense_lead: int = 0  # leading layers with dense (non-MoE) FFN
    rope_yarn_log_mul: float = 0.0
    # hybrid attention+recurrent (Jamba family): per-layer kv head counts,
    # 0 = recurrent layer (src/models/jamba.cpp:12)
    kv_head_pattern: tuple = ()
    head_pattern: tuple = ()  # per-layer n_head (openelm/deci; 0 = no attn)
    hybrid_graph: bool = False  # route through the hybrid group walker
    # even without recurrent layers (deci/openelm per-layer-shape archs)
    ffn_only_layers: bool = False  # nemotron-h: kv==0 AND ff>0 marks an
    # FFN-only layer (not recurrent); other hybrids put FFN on every layer
    # T5 family: relative position buckets (no rope)
    n_rel_attn_bkts: int = 0
    # RWKV family
    wkv_head_size: int = 0  # >0 selects the RWKV graph (rwkv7.cpp)
    rescale_every: int = 0  # rwkv6: halve activations every N layers
    n_ff_pattern: tuple = ()  # per-layer n_ff (nemotron-h: 0 = no-FFN layer)
    mrope_sections: tuple = ()  # qwen2vl M-RoPE t/h/w/e freq sections
    diffusion: bool = False  # llada/dream: bidirectional diffusion LM
    pre_norm: bool = True  # olmo2/exaone4: False = post-norms ONLY
    hybrid_parallel: bool = False  # falcon-h1: attn + mamba2 in EVERY layer
    hybrid_rope: bool = False  # hybrid attn layers rope (falcon-h1/granite)
    # qwen3next: Q projection emits [query | sigmoid output gate] per head
    attn_out_gate: bool = False
    # qwen3next: every Nth layer is full attention, the rest gated delta
    # net (LLM_KV_FULL_ATTENTION_INTERVAL, src/models/qwen3next.cpp:17-23)
    full_attn_interval: int = 0
    # recurrent (Mamba/SSM) models
    ssm_d_conv: int = 0  # conv kernel width (0 = not an SSM arch)
    ssm_d_inner: int = 0
    ssm_d_state: int = 0
    ssm_dt_rank: int = 0  # mamba2: the SSM head count
    ssm_n_group: int = 0  # mamba2: B/C group count
    ssm_dt_b_c_rms: bool = False  # FalconMamba: RMS-norm dt/B/C
    raw_kv: dict = field(default_factory=dict, repr=False)

    @property
    def n_gqa_groups(self) -> int:
        return self.n_head // max(self.n_head_kv, 1)


# {arch}.* keys the covered paths read. Any other {arch}.* key, and the
# arch-unprefixed xielu.* keys outside apertus, configure a feature the port
# does not run (expert groups, M-RoPE sections, pooling, ...):
# config_from_gguf raises on them rather than parsing and ignoring them.
# attention.layer_norm_epsilon goes to norm_eps as in the JAX parser; the
# layernorm archs read it (models/llama.py:_norm).
DENSE_KEYS = frozenset({
    "context_length", "embedding_length", "block_count", "feed_forward_length",
    "vocab_size", "attention.head_count", "attention.head_count_kv",
    "attention.key_length", "attention.value_length",
    "attention.layer_norm_rms_epsilon", "attention.layer_norm_epsilon",
    "attention.scale", "rope.freq_base",
    "rope.dimension_count", "rope.scaling.type", "rope.scaling.factor",
    "rope.scaling.original_context_length",
    # the gemma family's sliding windows (the pattern a scalar period or a
    # per-layer 0/1 array: exaone4, step35; llama4's chunk, as the JAX parser
    # reads it, config.py:240: llama.cpp appears to fix 8192 in code, so a
    # file without the key has no chunked layer here either), softcaps and
    # SWA rope base; the
    # granite/minicpm scales (gemma's embedding scale comes from its registry
    # row)
    "attention.sliding_window", "attention.sliding_window_pattern",
    "attn_logit_softcapping", "final_logit_softcapping", "rope.freq_base_swa",
    "embedding_scale", "residual_scale", "logit_scale",
    # olmo's clamp of q, k and v
    "attention.clamp_kqv",
    # the ALiBi archs' bias (bloom, mpt, jais; baichuan-13b's files), which
    # turns RoPE off
    "attention.max_alibi_bias",
    # mimo2's scale on the attention's output after wo (config.py:346-348)
    "attention.value_scale",
})
# gemma4's and gemma3n's per-layer token stream width and the trailing layers
# that read an earlier layer's cache (config.py:330-339); gemma4's SWA head
# dims, which no JAX graph reads, held equal to the head dims. Read for those
# two archs only: the JAX parser reads the first two for any arch, whose graph
# then runs shared layers only under gemma4's attention (llama.py:1396-1398),
# so another arch's file with these keys raises
GEMMA_PLE_KEYS = frozenset({
    "embedding_length_per_layer_input", "attention.shared_kv_layers",
    "attention.key_length_swa", "attention.value_length_swa",
})
GEMMA_PLE_ARCHS = ("gemma4", "gemma3n")
# the routed-expert MoE FFN (config.py:236-238, 272-280 of the JAX parser).
# expert_shared_feed_forward_length (qwen2moe) is read by neither parser:
# the shared expert's width comes from its tensors
MOE_KEYS = frozenset({
    "expert_count", "expert_used_count", "expert_feed_forward_length",
    "expert_weights_scale", "expert_weights_norm", "expert_gating_func",
    "expert_shared_feed_forward_length",
    # the shared experts' count (config.py:239): the width comes from the
    # shared expert's tensors, which the graph reads as one FFN
    "expert_shared_count",
    # the dense layers ahead of the MoE layers (config.py:258-259; which FFN
    # a layer runs follows its tensors) and the NextN/MTP layers, which no
    # graph runs: they come off n_layer and their tensors are not read
    # (config.py:260-265)
    "leading_dense_block_count", "nextn_predict_layers",
    # llama4's MoE period: 1 (every layer MoE, Scout's files) passes; any
    # other value raises (config_from_gguf)
    "interleave_moe_layer_step",
})
# MLA, the compressed-KV attention of the deepseek2 family (config.py:243-257
# of the JAX parser): the q and kv low ranks, the per-head q and v dims of
# the split convention (key/value_length then give the compressed cache's
# row), and YaRN's attention multiplier, stored as 0.1 x its value
MLA_KEYS = frozenset({
    "attention.q_lora_rank", "attention.kv_lora_rank", "attention.key_length_mla",
    "attention.value_length_mla", "rope.scaling.yarn_log_multiplier",
})
# grovemoe's chunk experts (config.py:371-378 of the JAX parser): the group
# size (a chunk expert a group of experts_per_group routed experts), the
# scale of the chunk bank's output and its width (read from the tensors; the
# key is carried as the JAX parser carries it). Read for grovemoe only:
# llama.cpp's graph reads them in grovemoe's alone, while the JAX graph
# would switch any arch's top-k to sigmoid selection on them
# (llama.py:395-397), so another arch's file with these keys raises
GROVE_KEYS = frozenset({
    "experts_per_group", "expert_group_scale", "expert_chunk_feed_forward_length",
})
# glm-dsa's DSA indexer, whose tensors the reference loads and its graph
# does not run (src/models/glm-dsa.cpp): its keys go through unread, as in
# the JAX parser
INDEXER_KEYS = frozenset({
    "attention.indexer.head_count", "attention.indexer.key_length", "attention.indexer.top_k",
})
# apertus's xIELU parameters, arch-unprefixed per-layer arrays (config.py:357-370
# of the JAX parser, which reads them for any arch's file; llama.cpp's graph
# reads them in apertus's alone, so another arch's file with them raises)
XIELU_KEYS = frozenset({"xielu.alpha_n", "xielu.alpha_p", "xielu.beta", "xielu.eps"})


def xielu_params(alpha_n, alpha_p, beta, eps, n_layer: int) -> tuple:
    """Each layer's (alpha_n, alpha_p, beta, eps) after the build-time
    softplus fold (config.py:357-370; ggml_xielu): alpha_p' = softplus(alpha_p),
    alpha_n' = beta + softplus(alpha_n), softplus(x) = x from 30 up. A scalar
    stands for every layer; beta defaults to 0.5 and eps to -1e-6 where None."""
    def arr(v, default):
        v = default if v is None else v
        v = [v] * n_layer if np.isscalar(v) else list(v)
        if len(v) < n_layer:
            raise ValueError(f"xielu: {len(v)} values for {n_layer} layers")
        return [float(x) for x in v]

    sp = lambda x: float(np.log1p(np.exp(min(x, 30.0))) if x < 30 else x)
    a_n, a_p = arr(alpha_n, None), arr(alpha_p, None)
    b, e = arr(beta, 0.5), arr(eps, -1e-6)
    return tuple((b[i] + sp(a_n[i]), sp(a_p[i]), b[i], e[i]) for i in range(n_layer))


def config_from_gguf(g: GGUFFile) -> ModelConfig:
    arch = g.architecture
    from .registry import ARCH_REGISTRY, apply_arch_defaults

    if arch not in ARCH_REGISTRY:
        raise NotImplementedError(
            f"arch {arch!r}: the PyTorch port covers {sorted(ARCH_REGISTRY)}")
    known = (DENSE_KEYS | MOE_KEYS | MLA_KEYS | (INDEXER_KEYS if arch == "glm-dsa" else set())
             | (GROVE_KEYS if arch == "grovemoe" else set())
             | (GEMMA_PLE_KEYS if arch in GEMMA_PLE_ARCHS else set()))
    other = sorted(k for k in g.metadata if (
        k.startswith("xielu.") and not (arch == "apertus" and k in XIELU_KEYS)) or (
        k.startswith(arch + ".") and k[len(arch) + 1:] not in known))
    if other:
        raise NotImplementedError(f"GGUF keys outside the covered {arch} paths: {other}")

    def get(key: str, default: Any = None) -> Any:
        v = g.get(f"{arch}.{key}", default)
        if isinstance(v, (list, tuple, np.ndarray)):
            raise NotImplementedError(
                f"{arch}.{key}: per-layer values are not on the covered {arch} paths")
        return v

    n_embd = int(get("embedding_length", 2048))
    n_head = int(get("attention.head_count", 32))
    head_dim = int(get("attention.key_length", n_embd // max(n_head, 1)))
    n_vocab = get("vocab_size")
    if n_vocab is None:
        toks = g.get("tokenizer.ggml.tokens")
        n_vocab = len(toks) if toks is not None else 32000
    cfg = ModelConfig(
        arch=arch,
        vocab_size=int(n_vocab),
        n_embd=n_embd,
        n_layer=int(get("block_count", 22)),
        n_head=n_head,
        n_head_kv=int(get("attention.head_count_kv", n_head)),
        head_dim=head_dim,
        head_dim_v=int(get("attention.value_length", head_dim)),
        n_ff=int(get("feed_forward_length", 4 * n_embd)),
        n_ctx_train=int(get("context_length", 2048)),
        rms_eps=float(get("attention.layer_norm_rms_epsilon", 1e-5)),
        norm_eps=float(get("attention.layer_norm_epsilon", 0.0)),
        rope_base=float(get("rope.freq_base", 10000.0)),
        rope_dim=int(get("rope.dimension_count", head_dim)),
        rope_scaling=str(get("rope.scaling.type", "none") or "none"),
        rope_scale=float(get("rope.scaling.factor", 1.0)),
        rope_orig_ctx=int(get("rope.scaling.original_context_length", 0)),
        n_expert=int(get("expert_count", 0)),
        n_expert_used=int(get("expert_used_count", 0)),
        n_ff_exp=int(get("expert_feed_forward_length", 0)),
        n_expert_shared=int(get("expert_shared_count", 0)),
        sliding_window=int(get("attention.sliding_window", 0)),
        raw_kv=dict(g.metadata),
    )
    for key, attr in (("embedding_scale", "embedding_scale"),
                      ("residual_scale", "residual_scale"), ("logit_scale", "logit_scale"),
                      ("attn_logit_softcapping", "attn_logit_softcap"),
                      ("final_logit_softcapping", "final_logit_softcap")):
        v = get(key)
        if v is not None:
            setattr(cfg, attr, float(v))
    # the SWA pattern (config.py:284-291): a scalar period, or a per-layer
    # 0/1 array (exaone4's published files, step35, mimo2, gemma4), whose
    # flags swa_flags reads, with swa_pattern 2 as the "any SWA" marker; the
    # one per-layer array read (get refuses the others)
    swp = g.get(f"{arch}.attention.sliding_window_pattern", 0)
    if isinstance(swp, (list, tuple, np.ndarray)):
        cfg.swa_layer_pattern = tuple(bool(x) for x in swp)
        cfg.swa_pattern = 2
    else:
        cfg.swa_pattern = int(swp or 1)
    cfg.rope_base_swa = float(get("rope.freq_base_swa", 0.0) or 0.0)
    cl = get("attention.clamp_kqv")
    if cl is not None:
        cfg.clamp_kqv = float(cl)
    cfg.alibi_max_bias = float(get("attention.max_alibi_bias", 0.0) or 0.0)
    asc = get("attention.scale")
    if asc is not None:
        cfg.attn_scale = float(asc)
    vsc = get("attention.value_scale")
    if vsc is not None and float(vsc) != 1.0:  # mimo2 (config.py:346-348)
        cfg.attn_out_scale = float(vsc)
    ew_scale = get("expert_weights_scale")
    if ew_scale is not None:
        cfg.expert_weights_scale = float(ew_scale)
    ew_norm = get("expert_weights_norm")
    if ew_norm is not None:
        cfg.expert_weights_norm = bool(ew_norm)
    gf = get("expert_gating_func")
    if gf is not None:
        cfg.expert_gating = {2: "sigmoid"}.get(int(gf), "softmax")
    # MLA (config.py:243-257): head_dim and head_dim_v are the per-head q and
    # v dims, which the split convention's *_mla keys carry
    cfg.q_lora_rank = int(get("attention.q_lora_rank", 0) or 0)
    cfg.kv_lora_rank = int(get("attention.kv_lora_rank", 0) or 0)
    if cfg.kv_lora_rank:
        k_mla, v_mla = get("attention.key_length_mla"), get("attention.value_length_mla")
        if k_mla:
            cfg.head_dim = int(k_mla)
        if v_mla:
            cfg.head_dim_v = int(v_mla)
        cfg.rope_yarn_log_mul = float(
            get("rope.scaling.yarn_log_multiplier", 0.0) or 0.0) / 0.1
    cfg.n_layer_dense_lead = int(get("leading_dense_block_count", 0) or 0)
    step = int(get("interleave_moe_layer_step", 1) or 1)
    if step != 1:
        # Maverick's files interleave dense and MoE layers (step 2), which no
        # JAX graph builds: the JAX parser reads no such key and runs every
        # layer by its tensors
        raise NotImplementedError(
            f"{arch}.interleave_moe_layer_step={step}: dense layers interleaved with the "
            "MoE layers (Llama-4-Maverick's files) are not on the covered paths; 1 (every "
            "layer MoE, Scout's) is")
    nge = get("experts_per_group")
    if nge is not None:
        cfg.n_group_experts = int(nge)
    egs = get("expert_group_scale")
    if egs is not None:
        cfg.expert_group_scale = float(egs)
    cfg.n_ff_chexp = int(get("expert_chunk_feed_forward_length", 0) or 0)
    nextn = int(get("nextn_predict_layers", 0) or 0)
    if nextn:
        cfg.n_layer -= nextn
    # the per-layer token stream and the shared-KV layers (config.py:330-339):
    # gemma3n's graph fixes its first 20 layers as the cache's owners whatever
    # the file says
    pl = get("embedding_length_per_layer_input")
    if pl:
        cfg.n_embd_per_layer = int(pl)
    shared_kv = get("attention.shared_kv_layers")
    if shared_kv:
        cfg.n_layer_kv_from_start = cfg.n_layer - int(shared_kv)
    if arch == "gemma3n":
        cfg.n_layer_kv_from_start = min(20, cfg.n_layer)
    for key, want in (("attention.key_length_swa", cfg.head_dim),
                      ("attention.value_length_swa", cfg.head_dim_v)):
        v = get(key)
        if v is not None and int(v) != want:
            raise NotImplementedError(
                f"{arch}.{key}={v}: SWA layers with their own head dim ({want} elsewhere) are "
                "not on the covered paths")
    if g.get("xielu.alpha_n") is not None:  # apertus (config.py:357-370)
        cfg.xielu = xielu_params(*(g.get(k) for k in ("xielu.alpha_n", "xielu.alpha_p",
                                                      "xielu.beta", "xielu.eps")), cfg.n_layer)
    if cfg.swa_layer_pattern and len(cfg.swa_layer_pattern) < cfg.n_layer:
        raise ValueError(f"{arch}.attention.sliding_window_pattern: "
                         f"{len(cfg.swa_layer_pattern)} flags for {cfg.n_layer} layers")
    if arch == "qwen":  # qwen-v1 GGUF stores DOUBLE the ffn width
        cfg.n_ff //= 2
    apply_arch_defaults(cfg)
    if cfg.alibi_max_bias > 0:  # ALiBi replaces RoPE, after the row's defaults (refact's bias)
        cfg.use_rope = False
    if arch == "smallthinker" and cfg.sliding_window:
        # the SWA layers rope, the periodic dense layers do not (config.py:405-408)
        cfg.no_rope_interval = cfg.swa_pattern
    return cfg
