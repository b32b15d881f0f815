"""Decoder-only transformer graph (dense Llama-family and Mixtral-style MoE)
in PyTorch.

Counterpart of tpullm/models/llama.py for the configurations the port
covers: the token embedding (times embedding_scale: gemma, granite,
minicpm), plus a learned position table (gpt2, starcoder) and a layernorm
on the embedding (bloom) -> RMSNorm or layernorm (with or without weight
and bias) -> fused
QKV (or the GGUF-fused attn_qkv) -> optional q/k/v biases -> optional q/k
norms (per head before or after RoPE, RMS or chameleon's layernorm with
per-head weights and biases, or over the flat rows with their biases) ->
BitNet's optional per-tensor q/k/v scales -> RoPE (neox or interleaved,
full or partial; SWA layers at rope_base_swa where the file gives one; none
where use_rope is off) -> an
optional clamp of q, k and v -> GQA attention over a head-major KV cache
(optional logit softcap; a sliding window on the layers swa_pattern or the
per-layer swa_layer_pattern marks; or ALiBi, without either; optional
per-head sink logits, gpt-oss's and mimo2's, as a key without a value) ->
step35's optional per-head sigmoid gate -> BitNet's optional attention
sub-norm -> output projection, its optional scale and bias -> mimo2's
optional value scale -> gated SiLU, GELU or gpt-oss's clamped SwiGLU
(swiglu_oai) FFN (optional gate and up biases and scales; gate and up fused,
separate or GGUF-combined in one ffn_up), ungated GELU, relu2 or apertus's
xIELU FFN (optional up and down biases), BitNet's optional FFN sub-norm
before down and down's scale,
in sequence or in parallel with attention (the parallel residual), or the
routed-expert MoE FFN (softmax or sigmoid router with an optional bias on
its logits, an optional selection bias for the top-k choice, top-k,
optional renormalization and scale, gated SiLU or swiglu_oai experts with
optional gate, up and down biases, an optional gated SiLU shared expert
with an optional per-token sigmoid gate; no latent or chunk experts; dense
layers ahead of the MoE layers, each run as its tensors say); optional
post-attention and post-FFN
norms, with or without the pre-norms (``pre_norm``); residual branches
times residual_scale; logits times logit_scale, then the final softcap.
MLA layers (the deepseek2 family, ``kv_lora_rank``) take the compressed-KV
attention in its absorbed form instead (``attend_mla``: a direct or
low-rank q, the joint kv projection and its latent norm, q_nope absorbed by
wk_b, one cached kv head of [c_kv; k_pe] and c_kv, attention at
``mla_scale`` with YaRN's mscale^2, wv_b, then wo) ahead of the pre-normed
dense or MoE FFN. The per-layer-embedding Gemmas (gemma4, gemma3n) add the
per-layer token stream (a (vocab, n_layer x P) table gathered by token and a
projection of the embedded input, ``per_layer_inputs``) that each layer's
per-layer input block adds in (``per_layer_block``), gemma4's attention (a
weightless V norm, V as the raw K where a layer has no wv) and output scale,
the shared-KV layers (Q alone over an earlier layer's bank, ``bank_map``),
and gemma3n's AltUp stream stack with LAuReL and the activation sparsity
(``altup_expand``, ``altup_layer``, ``altup_merge``: plain ops beside the
layer's products). A Python loop over layers takes the place of
``lax.scan``; the KV cache
(bf16, f32 or int8 with row scales; full-context on every layer, or the
iSWA dual cache: full banks for the full-attention layers and a ring of
window + chunk slots for the SWA layers) is updated in place, in the
batch engine's layout or the server's per-slot rows. Every flag of the JAX
graph that these paths never set raises (``check_dense``) instead of being
ignored.

Kernel gates are the JAX package's own, with "the tensors are on the card"
in place of "the default backend is the TPU": prefill attention takes the
flash kernel when flash_supported holds (llama.py:268-274); decode
attention takes kernel E when flash_decode_supported holds (off unless
TPULLM_FLASH_DECODE is set, llama.py:277-294), each only on the shapes its
kernel builds (attention_route; the rest take the einsum path). A layer's
window is a Python int here (``layer_windows``), so interleaved SWA layers
take kernels C and E with their own window and the config's softcap, where
the JAX package's scan passes a traced window and falls through to its
einsum path (llama.py:268-277, 932-941): the same function on another
route. Ring layers (the dual cache's SWA banks) take kernels E and C over
the ring by position, and the store writes the ring with wrap, where the
JAX package sends them to its einsum path (llama.py:268, 277: ``not
ring``); that route is the port's own (attention_route). ALiBi takes
kernels C and E with the slopes as one more term on each score, where the
JAX package sends it to its einsum path (llama.py:268-279): the port's own
route too. Head dim 64 (gpt-oss) takes kernel E as the port's own route,
where the JAX gate asks Dk % 128 == 0 (flash_decode.py:254). Sinks keep a
call off kernel C, as the JAX prefill gate asks ``sinks is None``
(llama.py:268). Decode layers take the layer kernel, folded with the next
layer's QKV when the weights are fused in one group (llama.py:1382-1423,
``layer_routes``); MoE prefill (B*T > 16) takes
the grouped kernel F over expert-sorted rows (llama.py:455-460) and MoE
decode (B*T <= 16) kernel A's expert-skip variant over the selected experts
(llama.py:447-454, ``moe_route``). MLA attention takes the einsum path
(its own scale: the JAX prefill gate wants ``scale is None``,
llama.py:268; Dk != Dv, which C and E do not build) and no layer kernel
(llama.py:1395).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.flash_attention import (alibi_of, attention_params, flash_attention, flash_builds,
                                   flash_supported, masked_attention)
from ..ops.flash_decode import (flash_decode, flash_decode_builds, flash_decode_own_supported,
                                flash_decode_ring_supported, flash_decode_supported)
from ..ops.fuse import pad256
from ..ops.kv_store import kv_quant as _kv_quant  # noqa: F401 (the JAX name)
from ..ops.kv_store import kv_store
from ..ops.layer_kernel import ffn_block, ffn_block_qkv
from ..ops.layer_kernel import supported as block_supported
from ..ops.moe_decode import MAX_ROWS, moe_decode, skip_supported
from ..ops.qmm import qmm
from ..ops.qtensor import QTensor
from ..quant.kmajor import f32_on_device
from .config import ModelConfig

# ModelConfig fields the dense decoder path reads; every other field must
# keep its default (check_dense). norm_eps is the layernorm archs' eps.
DENSE_FIELDS = frozenset({
    "arch", "vocab_size", "n_embd", "n_layer", "n_head", "n_head_kv",
    "head_dim", "head_dim_v", "n_ff", "n_ctx_train", "rms_eps", "norm_eps",
    "rope_base", "rope_dim", "rope_type", "rope_scaling", "rope_scale",
    "rope_orig_ctx", "rope_yarn_low", "rope_yarn_high", "rope_attn_factor",
    "attn_scale", "tie_embeddings", "raw_kv",
    # the flags of qwen2/qwen (biases), qwen3/hunyuan-dense/maincoder (q/k
    # norms), olmo2 (flat q/k norms), glm4/exaone4/olmo2 (post-norms)
    "attn_bias", "attn_qk_norm", "qk_norm_post_rope", "attn_qk_norm_flat",
    "post_norms", "pre_norm",
    # the gemma family (gelu, the embedding scale, softcaps, sliding windows
    # every swa_pattern-th layer full or by a per-layer array, the SWA layers'
    # own rope base) and the granite/minicpm scales
    "act_fn", "embedding_scale", "attn_logit_softcap", "final_logit_softcap",
    "sliding_window", "swa_pattern", "swa_layer_pattern", "rope_base_swa", "residual_scale",
    "logit_scale",
    # step35's per-head sigmoid gate on the attention output (wqkv_gate, one
    # column a head; afmoe's gate as wide as the output raises in forward)
    "attn_gate_proj",
    # the layernorm, bias and parallel-residual decoders (stablelm, starcoder2,
    # phi2, command-r, falcon, olmo's clamp, nemotron's relu2, ...)
    "norm_type", "ffn_gate", "parallel_residual", "clamp_kqv",
    # the decoders without RoPE: learned positions (gpt2, starcoder) or ALiBi
    # (bloom, mpt, jais, refact, baichuan-13b's files)
    "use_rope", "alibi_max_bias",
    # mimo2's scale on the attention output after wo (llama.py:1268-1269)
    "attn_out_scale",
    # the iRoPE decoders (llama4, smallthinker, afmoe): NoPE layers on a
    # period, llama4's attention temperature on them and its weightless L2
    # QK norm on the roped ones, chunked windows, smallthinker's dense-first
    # SWA pattern
    "no_rope_interval", "no_rope_offset", "attn_temp_scale", "attn_temp_floor",
    "attn_temp_offset", "qk_l2_norm", "swa_chunked", "swa_dense_first",
    # the per-layer-embedding Gemmas (gemma4, gemma3n): the per-layer token
    # stream, the trailing layers that read an earlier layer's cache, gemma4's
    # attention (the weightless V norm, V as K where a layer has no wv) and
    # gemma3n's AltUp stream stack with its activation sparsity
    "n_embd_per_layer", "n_layer_kv_from_start", "gemma4_attn", "altup_n", "altup_act",
    "n_layer_sparsity", "sparsity_std_mul",
    # the dense singles: chameleon's per-head layernorm QK norm, apertus's
    # xIELU parameters, bitnet's sub-norms (check_dense holds each to its
    # block)
    "qk_norm_type", "xielu", "sub_norms",
})
# act_fn values of the dense FFN (llama.py:624-658): gated silu, gelu or
# gpt-oss's clamped swiglu_oai, ungated gelu, relu2 or apertus's xielu; the
# MoE FFN's experts run gated silu, grok's gelu, swiglu_oai or smallthinker's
# relu (llama.py:431-440)
GATED_ACTS, UNGATED_ACTS = ("silu", "gelu", "swiglu_oai"), ("gelu", "relu2", "xielu")
MOE_ACTS = ("silu", "gelu", "swiglu_oai", "relu")
NORM_TYPES = ("rmsnorm", "layernorm")
# the routed-expert MoE FFN's fields, accepted only with MoE tensors; the
# dense lead's count is informational, as in the JAX graph: which FFN a
# layer runs follows its tensors. smallthinker's router reads the residual
# stream ahead of ffn_norm (moe_router_pre_norm). grovemoe's chunk experts
# (the group size, the bank's scale and width) and the dense FFN beside the
# MoE (grok's and arctic's blocks, moe_dense_parallel)
MOE_FIELDS = frozenset({
    "n_expert", "n_expert_used", "expert_gating", "expert_weights_norm",
    "expert_weights_scale", "n_ff_exp", "n_layer_dense_lead", "n_expert_shared",
    "moe_router_pre_norm", "n_group_experts", "expert_group_scale", "n_ff_chexp",
    "moe_dense_parallel",
})
MOE_DENSE_PARALLEL = ("", "grok", "arctic")
# MLA, the compressed-KV attention of the deepseek2 family (llama.py:973-1041),
# on the dense decoder's layers or beside the MoE FFN
MLA_FIELDS = frozenset({"q_lora_rank", "kv_lora_rank", "rope_yarn_log_mul"})
# the flags an MLA layer does not read (the JAX layer's MLA branch,
# llama.py:1159-1174, runs the pre-norms, the attention, wo and the FFN
# alone, and its attention takes mla_scale): each raises beside MLA
MLA_UNREAD_FIELDS = ("attn_bias", "attn_qk_norm", "qk_norm_post_rope", "attn_qk_norm_flat",
                     "post_norms", "parallel_residual", "clamp_kqv", "sliding_window",
                     "attn_logit_softcap", "alibi_max_bias", "residual_scale", "attn_scale",
                     "pre_norm", "use_rope", "norm_type", "attn_gate_proj", "attn_out_scale")
MOE_KEYS = frozenset({"moe_gate_inp", "moe_gate_exps", "moe_up_exps", "moe_down_exps"})
# gpt-oss's expert biases (E, n) and the router's bias on its logits (E,),
# f32 layer tensors read only beside MOE_KEYS (llama.py:385-386, 423-443)
EXPERT_BIAS_KEYS = frozenset({"moe_gate_exps_b", "moe_up_exps_b", "moe_down_exps_b"})
MOE_BIAS_KEYS = EXPERT_BIAS_KEYS | {"moe_gate_inp_b"}
# the shared expert of MoE layers (qwen2moe: with its sigmoid gate), read
# only beside MOE_KEYS (llama.py:498-510)
SHEXP_KEYS = frozenset({"ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp"})
# grovemoe's chunk-expert bank (E // n_group_experts experts of n_ff_chexp),
# read only beside MOE_KEYS with n_group_experts (llama.py:466-493)
CHEXP_KEYS = frozenset({"moe_gate_chexps", "moe_up_chexps", "moe_down_chexps"})
# the dense FFN's weights, read on a MoE layer by grok's and arctic's blocks
# only (llama.py:1295-1314)
DENSE_FFN_KEYS = frozenset({"ffn_gateup", "ffn_gate", "ffn_up", "ffn_down"})
# the per-layer input block of gemma4's and gemma3n's layers (its weights and
# its post-norm), read beside the per-layer token stream (n_embd_per_layer);
# gemma3n's AltUp and LAuReL tensors, read where the config has altup_n
# (llama.py:1042-1147)
PLE_KEYS = frozenset({"per_layer_inp_gate", "per_layer_proj", "per_layer_post_norm"})
ALTUP_KEYS = frozenset({"altup_correct_coef", "altup_correct_scale", "altup_predict_coef",
                        "altup_router", "altup_router_norm", "laurel_l", "laurel_r",
                        "laurel_post_norm"})
# the model-wide tables of the per-layer token stream and of the AltUp
# streams' expansion and merge (llama.py:734-766, 1531-1541)
PLE_TABLES = ("per_layer_tok_embd", "per_layer_model_proj", "per_layer_proj_norm")
ALTUP_TABLES = ("altup_proj", "altup_unembd_proj")


def _informational(cfg: ModelConfig, name: str) -> bool:
    """A MoE field that describes no expert of a config without MoE
    tensors, which the JAX graph does not read there: the router's gating
    (glm-dsa's row sets sigmoid), the expert width of a config with no
    experts, and a dense lead that covers every layer (the deepseek2
    family's dense files carry both)."""
    return (name == "expert_gating" or (name == "n_ff_exp" and cfg.n_expert == 0)
            or (name == "n_layer_dense_lead" and cfg.n_layer_dense_lead >= cfg.n_layer))


def check_dense(cfg: ModelConfig, moe: bool = False) -> None:
    """Raise on any config flag outside the covered paths: the dense decoder
    path with its attention or MLA, and with ``moe`` (the layers carry MoE
    tensors) the MoE FFN. Without MoE tensors the MoE fields that describe
    no expert pass (``_informational``); every other one raises."""
    allowed = DENSE_FIELDS | MLA_FIELDS | (MOE_FIELDS if moe else frozenset())
    for f in dataclasses.fields(ModelConfig):
        if f.name in allowed or (not moe and _informational(cfg, f.name)):
            continue
        default = f.default if f.default is not dataclasses.MISSING else f.default_factory()
        if getattr(cfg, f.name) != default:
            raise NotImplementedError(
                f"ModelConfig.{f.name}={getattr(cfg, f.name)!r}: not on the "
                f"{'dense decoder or MoE' if moe else 'dense decoder'} path the PyTorch "
                "port covers")
    acts = MOE_ACTS if moe else GATED_ACTS if cfg.ffn_gate else UNGATED_ACTS
    if cfg.act_fn not in acts:
        raise NotImplementedError(
            f"ModelConfig.act_fn={cfg.act_fn!r}: the {'MoE' if moe else 'dense'} "
            f"{'gated' if cfg.ffn_gate else 'ungated'} FFN of the PyTorch port runs "
            + " or ".join(acts))
    if cfg.norm_type not in NORM_TYPES:
        raise NotImplementedError(
            f"ModelConfig.norm_type={cfg.norm_type!r}: the port runs " + " or ".join(NORM_TYPES))
    if cfg.alibi_max_bias > 0 and (cfg.sliding_window or cfg.attn_logit_softcap):
        # no arch of the JAX registry has both; the kernels take ALiBi alone
        raise NotImplementedError(
            f"ModelConfig.alibi_max_bias={cfg.alibi_max_bias} with sliding_window="
            f"{cfg.sliding_window}, attn_logit_softcap={cfg.attn_logit_softcap}: ALiBi runs "
            "without a window, a ring or a softcap in the port")
    if moe and (cfg.n_expert < 1 or not 1 <= cfg.n_expert_used <= cfg.n_expert
                or cfg.expert_gating not in ("softmax", "sigmoid")
                or cfg.moe_dense_parallel not in MOE_DENSE_PARALLEL
                or cfg.moe_dense_parallel and (cfg.parallel_residual or cfg.kv_lora_rank)
                or cfg.n_group_experts and cfg.n_expert % cfg.n_group_experts):
        raise NotImplementedError(
            f"MoE with n_expert={cfg.n_expert}, n_expert_used={cfg.n_expert_used}, "
            f"gating {cfg.expert_gating!r}, moe_dense_parallel {cfg.moe_dense_parallel!r}, "
            f"n_group_experts {cfg.n_group_experts}: not on the covered MoE path")
    nks = cfg.n_layer_kv_from_start
    if 0 <= nks < cfg.n_layer and (not cfg.gemma4_attn or nks < 2 or cfg.kv_lora_rank):
        # the JAX graph runs shared layers under gemma4's attention alone
        # (llama.py:1396-1398), reading banks nks - 1 and nks - 2
        raise NotImplementedError(
            f"n_layer_kv_from_start={nks} of {cfg.n_layer} layers (gemma4_attn "
            f"{cfg.gemma4_attn}, kv_lora_rank {cfg.kv_lora_rank}): shared-KV layers read the "
            "banks of two owning layers under gemma4's attention")
    if cfg.altup_n and not (cfg.altup_n > 1 and 0 <= cfg.altup_act < cfg.altup_n
                            and cfg.n_embd_per_layer and cfg.pre_norm
                            and not (moe or cfg.kv_lora_rank or cfg.parallel_residual)):
        raise NotImplementedError(
            f"altup_n={cfg.altup_n}, altup_act={cfg.altup_act}, n_embd_per_layer="
            f"{cfg.n_embd_per_layer}: the AltUp layer runs 2 or more streams beside the "
            "per-layer token stream, on the sequential dense block")
    if (cfg.act_fn == "xielu" or cfg.xielu) and not (
            cfg.act_fn == "xielu" and len(cfg.xielu) == cfg.n_layer and not moe):
        # apertus: the JAX ffn reads layer li's (alpha_n, alpha_p, beta, eps)
        # on the ungated path alone (llama.py:645-655)
        raise NotImplementedError(
            f"ModelConfig.act_fn={cfg.act_fn!r} with xielu parameters for {len(cfg.xielu)} of "
            f"{cfg.n_layer} layers: xIELU runs on the ungated dense FFN with one (alpha_n, "
            "alpha_p, beta, eps) a layer")
    if cfg.qk_norm_type not in NORM_TYPES or cfg.qk_norm_type == "layernorm" and not (
            cfg.attn_qk_norm and not cfg.qk_norm_post_rope):
        # the JAX graph reads qk_norm_type in the per-head norm before RoPE
        # alone (llama.py:843-850): chameleon's layernorm with per-head weights
        raise NotImplementedError(
            f"ModelConfig.qk_norm_type={cfg.qk_norm_type!r} (attn_qk_norm {cfg.attn_qk_norm}, "
            f"qk_norm_post_rope {cfg.qk_norm_post_rope}): the layernorm QK norm runs per head "
            "before RoPE")
    if cfg.sub_norms and (moe or cfg.kv_lora_rank or cfg.altup_n):
        # bitnet's sub-norms: the JAX MoE FFN, MLA layer and AltUp layer read
        # none (llama.py:1159-1174, 371-515, 1071-1147)
        raise NotImplementedError(
            "ModelConfig.sub_norms=True with MoE, MLA or AltUp layers: the sub-norms run on the "
            "dense block")
    if cfg.n_layer_sparsity and not cfg.altup_n:
        raise NotImplementedError(
            f"n_layer_sparsity={cfg.n_layer_sparsity}: the activation sparsity is read by "
            "the AltUp layer alone (llama.py:1116-1124)")
    if cfg.kv_lora_rank:
        base = ModelConfig()
        unread = [f for f in MLA_UNREAD_FIELDS if getattr(cfg, f) != getattr(base, f)]
        if unread or not 0 < cfg.rope_dim < cfg.head_dim:
            raise NotImplementedError(
                f"MLA (kv_lora_rank {cfg.kv_lora_rank}) with {unread or 'rope_dim'} = "
                f"{[getattr(cfg, f) for f in unread] or cfg.rope_dim} (head_dim "
                f"{cfg.head_dim}): the MLA layer reads none of these flags and ropes a tail "
                "of the head")


def kv_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(kv heads, K row, V row) of the cache: with MLA one head of the
    compressed state, K [c_kv; k_pe] (kv_lora + rope_dim) and V c_kv
    (kv_lora), whatever the head counts (llama.py:82-88); otherwise the
    config's kv heads and head dims."""
    if cfg.kv_lora_rank:
        return 1, cfg.kv_lora_rank + cfg.rope_dim, cfg.kv_lora_rank
    return cfg.n_head_kv, cfg.head_dim, cfg.head_dim_v


def mla_scale(cfg: ModelConfig) -> float:
    """The MLA attention's scale (llama.py:1024-1034): 1/sqrt(head_dim), times
    mscale^2 under YaRN with a log multiplier (deepseek2.cpp's kq_scale)."""
    if cfg.rope_scaling == "yarn" and cfg.rope_scale > 1 and cfg.rope_yarn_log_mul:
        ms = cfg.rope_attn_factor * (1.0 + 0.1 * cfg.rope_yarn_log_mul * math.log(cfg.rope_scale))
        return ms * ms / math.sqrt(cfg.head_dim)
    return 1.0 / math.sqrt(cfg.head_dim)


def swa_flags(cfg: ModelConfig) -> list:
    """Per-layer is-SWA flags for interleaved local/global models
    (src/llama-hparams.h:132 set_swa_pattern: every swa_pattern-th layer
    is full attention)."""
    if cfg.sliding_window and cfg.swa_layer_pattern:
        # explicit per-layer flags (mimo2/step35/gemma4 swa_layers array)
        return [bool(f) for f in cfg.swa_layer_pattern[:cfg.n_layer]]
    if cfg.sliding_window and cfg.swa_pattern > 1:
        if cfg.swa_dense_first:  # smallthinker: layer il%p==0 is dense
            return [(li % cfg.swa_pattern) != 0 for li in range(cfg.n_layer)]
        return [((li + 1) % cfg.swa_pattern) != 0
                for li in range(cfg.n_layer)]
    return [False] * cfg.n_layer


def layer_windows(cfg: ModelConfig) -> list:
    """Each layer's window in tokens (0: none), as the JAX graph applies it
    on a single cache (llama.py:932-950): interleaved layers (swa_pattern >
    1) take the window where swa_flags says so, and no window elsewhere
    (JAX's 1 << 30 there masks nothing); with swa_pattern 1 a window covers
    every layer. The JAX package passes the interleaved window as a traced
    value, which sends those layers to its einsum path; here each layer's
    window is a Python int, so kernels C and E take it as the JAX kernels'
    static window (the same function on another route)."""
    if cfg.sliding_window and cfg.swa_pattern > 1:
        return [cfg.sliding_window if f else 0 for f in swa_flags(cfg)]
    return [cfg.sliding_window] * cfg.n_layer


def nope_flags(cfg: ModelConfig) -> list:
    """Each layer's NoPE flag (iRoPE, llama.py:873-885; llama4.cpp's
    n_no_rope_layer_step): no RoPE where (li + no_rope_offset) %
    no_rope_interval == 0, li the layer's index in the model, as llama.cpp
    counts it. The JAX graph takes li as the index within the layer's group
    (the scan's ids, llama.py:1443), which differs where the depth splits
    into groups at other than a multiple of the period (afmoe's dense lead
    ahead of its MoE layers, a mixed-type file): a departure from the
    reference (ROADMAP §3)."""
    n = cfg.no_rope_interval
    return [bool(n) and (li + cfg.no_rope_offset) % n == 0 for li in range(cfg.n_layer)]


def attn_temperature(cfg: ModelConfig, positions):
    """llama4's attention temperature of the NoPE layers' queries (B, T)
    f32 from the device positions (llama.py:879-882;
    llm_graph_input_attn_temp): log(floor((pos + offset) / floor) + 1) *
    scale + 1, so 1 below position floor - offset, exactly 1 at scale 0
    (smallthinker, afmoe). No host read: a captured step takes it."""
    pos = positions.to(torch.float32) + cfg.attn_temp_offset
    return torch.log(torch.floor(pos / cfg.attn_temp_floor) + 1.0) * cfg.attn_temp_scale + 1.0


@dataclass
class KVCache:
    """Per-model KV cache: k/v HEAD-MAJOR (L, B, H_kv, S_max, D), written in
    place by ``ops/kv_store.py:kv_store`` (one launch a layer on the card).
    bf16 or f32, or the int8 cache (``create(..., dtype="q8")``,
    llama.py:52-57): int8 k/v with per-(head, slot) f32 row scales ks/vs
    (L, B, H_kv, S_max), rows quantized on write (``_kv_quant``).

    The iSWA dual cache (``create(..., iswa=True, max_chunk=C)``,
    llama.py:80-117; llama_kv_cache_iswa): k/v hold only the full-attention
    layers (L_full, B, H_kv, S_max, D) and the ring banks kw/vw the SWA
    layers (L_swa, B, H_kv, ring, D), ring = min(window + max(C, 1), S_max):
    position p lives at ring slot p % ring. ``bank_map`` says which bank and
    index each layer uses. ring must be >= window + the most rows one
    forward writes (C), so that no slot a chunk overwrites holds a position
    one of its queries still sees."""

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor | None = None
    vs: torch.Tensor | None = None
    kw: torch.Tensor | None = None  # (L_swa, B, H_kv, ring, D): the SWA layers' ring
    vw: torch.Tensor | None = None
    ring: int = 0  # the ring's slots (0: one full-context bank for every layer)

    @staticmethod
    def create(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda", iswa: bool = False, max_chunk: int = 0) -> "KVCache":
        """The JAX KVCache.create: with ``iswa`` the dual cache where the
        config has SWA layers, except on the int8 cache and for chunked
        windows, gemma4's attention and MLA, as in the JAX package. An MLA
        config's cache holds its compressed rows (``kv_dims``). A config
        with shared-KV layers (gemma4, gemma3n) has banks for its first
        n_layer_kv_from_start layers alone (llama.py:91-96): the others read
        two of them (``bank_map``)."""
        n_kv = kv_owners(cfg)
        flags = swa_flags(cfg)[:n_kv]
        dual = (iswa and any(flags) and not cfg.swa_chunked and not cfg.gemma4_attn
                and not cfg.kv_lora_rank and dtype not in ("q8", "int8"))
        n_full = n_kv - sum(flags) if dual else n_kv
        hkv, dk, dv = kv_dims(cfg)
        shape_k = (n_full, batch, hkv, max_len, dk)
        shape_v = (n_full, batch, hkv, max_len, dv)
        if dtype in ("q8", "int8"):
            return KVCache(torch.zeros(shape_k, dtype=torch.int8, device=device),
                           torch.zeros(shape_v, dtype=torch.int8, device=device),
                           torch.zeros(shape_k[:-1], dtype=torch.float32, device=device),
                           torch.zeros(shape_v[:-1], dtype=torch.float32, device=device))
        if dtype not in (torch.bfloat16, torch.float32):
            raise NotImplementedError(f"KV cache dtype {dtype}: bf16, f32 and 'q8' only")
        z = lambda shape: torch.zeros(shape, dtype=dtype, device=device)
        if not dual:
            return KVCache(z(shape_k), z(shape_v))
        ring = min(cfg.sliding_window + max(max_chunk, 1), max_len)
        n_swa = sum(flags)
        return KVCache(z(shape_k), z(shape_v),
                       kw=z((n_swa, batch, cfg.n_head_kv, ring, cfg.head_dim)),
                       vw=z((n_swa, batch, cfg.n_head_kv, ring, cfg.head_dim_v)), ring=ring)

    @property
    def quantized(self) -> bool:
        return self.ks is not None

    @property
    def dual(self) -> bool:
        return self.kw is not None

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def nbytes(self) -> int:
        """Bytes of every bank (rings and row scales included)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.k, self.v, self.ks, self.vs, self.kw, self.vw)
                   if t is not None)


def kv_owners(cfg: ModelConfig) -> int:
    """The layers that own cache banks: the first n_layer_kv_from_start
    where the config sets it (gemma4, gemma3n), else every layer."""
    nks = cfg.n_layer_kv_from_start
    return nks if 0 <= nks < cfg.n_layer else cfg.n_layer


def bank_map(cfg: ModelConfig, dual: bool) -> list:
    """Each layer's bank and its index there, [(ring, index)]: on the dual
    cache the SWA layers (swa_flags) index the ring banks in layer order and
    the others the full banks (the JAX forward's bank_off, llama.py:1374-1508);
    otherwise every layer its own index of the full banks. A shared-KV
    layer (from kv_owners on) reads the bank of the last owning layer, or of
    the one before it where the layer is SWA (llama.py:1447-1465; llama.cpp's
    reuse callback): it writes none."""
    flags = swa_flags(cfg)
    n_kv = kv_owners(cfg)
    seen = {False: 0, True: 0}
    out = []
    for li, f in enumerate(flags):
        if li >= n_kv:
            out.append((False, n_kv - 2 if f else n_kv - 1))
            continue
        r = bool(dual and f)
        out.append((r, seen[r]))
        seen[r] += 1
    return out


def params_device(params: dict) -> torch.device:
    """The device of a model's params: its embedding's (olmo's weightless
    layernorm leaves no output_norm)."""
    return next(iter(params["tok_embd"].data.values())).device


def check_positions(params: dict, max_seq_len: int, what: str) -> None:
    """Raise ValueError where a model with a learned position table
    (pos_embd) gets a context longer than the table: its real positions
    (below ``max_seq_len``) must each have a row. Checked once, where an
    engine or a server is built; forward clamps the gather, so the padding
    and overshoot positions past the context read the last row and are
    thrown away. The JAX package reads NaN rows past the table instead
    (jnp.take) and builds with any context (ROADMAP §3)."""
    table = params.get("pos_embd")
    if table is not None and max_seq_len > table.shape[0]:
        raise ValueError(f"{what}: a context of {max_seq_len}, the learned position table "
                         f"has {table.shape[0]} rows")


def dequant_view(q, scale, dtype):
    """int8 rows and their f32 scales -> rows in ``dtype`` (llama.py:904-907)."""
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def rms_norm(x, w, eps):
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.to(torch.float32)
    return y.to(x.dtype)


def layer_norm(x, w, b, eps):
    """f32 mean and variance, then the optional weight and bias, cast back
    (llama.py:150-159); olmo's weightless layernorm has neither."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) * (xf - mu)).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.to(torch.float32)
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(x.dtype)


def _norm(x, w, b, cfg: ModelConfig):
    """The stream's norm by cfg.norm_type (llama.py:667-670): layernorm at
    norm_eps (rms_eps where the file gives none), else RMS, which reads no
    bias."""
    if cfg.norm_type == "layernorm":
        return layer_norm(x, w, b, cfg.norm_eps or cfg.rms_eps)
    return rms_norm(x, w, cfg.rms_eps)


def _rot_dim(n_rot: float, cfg: ModelConfig) -> float:
    return (cfg.rope_dim * np.log(cfg.n_ctx_train / (n_rot * 2 * np.pi))
            / (2 * np.log(cfg.rope_base)))


def rope_cache(cfg: ModelConfig, positions):
    """positions (B, T) -> (cos, sin) each (B, T, rope_dim//2), f32
    (ggml_rope_ext semantics, with linear or YaRN frequency scaling; YaRN's
    mscale multiplies both, as in the JAX package)."""
    theta, mscale = rope_angles(cfg, positions)
    return torch.cos(theta) * mscale, torch.sin(theta) * mscale


def rope_angles(cfg: ModelConfig, positions):
    """positions (B, T) -> (the rotation angles (B, T, rope_dim//2) f32,
    YaRN's mscale as a float: 1 without YaRN): rope_cache before the
    magnitude, for a pure rotation."""
    half = cfg.rope_dim // 2
    inv_freq = cfg.rope_base ** (-np.arange(0, half, dtype=np.float32) * 2.0 / cfg.rope_dim)
    inv_freq = f32_on_device(tuple(np.asarray(inv_freq, np.float32).tolist()), positions.device)
    pos = positions.to(torch.float32)[..., None]
    if cfg.rope_scaling == "linear" and cfg.rope_scale != 1.0:
        pos = pos / cfg.rope_scale
    theta = pos * inv_freq
    mscale = 1.0
    if cfg.rope_scaling == "yarn" and cfg.rope_orig_ctx:
        lo = max(cfg.rope_yarn_low, 0.001)
        hi = max(cfg.rope_yarn_high, lo + 0.001)
        d = np.arange(0, half, dtype=np.float32)
        low_rot = cfg.rope_orig_ctx / hi
        high_rot = cfg.rope_orig_ctx / lo
        ramp = np.clip(
            (d - _rot_dim(low_rot, cfg))
            / max(_rot_dim(high_rot, cfg) - _rot_dim(low_rot, cfg), 1e-3), 0, 1)
        ramp = f32_on_device(tuple(np.asarray(1 - ramp, np.float32).tolist()), positions.device)
        theta_extrap = pos * inv_freq
        theta_interp = pos * inv_freq / cfg.rope_scale
        theta = theta_interp * (1 - ramp) + theta_extrap * ramp
        mscale = float(0.1 * np.log(cfg.rope_scale) + 1.0) if cfg.rope_scale > 1 else 1.0
        mscale *= cfg.rope_attn_factor
    return theta, mscale


def apply_rope(x, cos, sin, rope_type: str, rope_dim: int):
    """x: (B, T, H, D). Rotates the first rope_dim dims of D."""
    xr = x[..., :rope_dim]
    rest = x[..., rope_dim:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    if rope_type == "neox":
        half = rope_dim // 2
        x1, x2 = xr[..., :half], xr[..., half:]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    else:  # "norm": interleaved pairs (x[2i], x[2i+1])
        x1 = xr[..., 0::2]
        x2 = xr[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(xr.shape)
    return torch.cat([out, rest], dim=-1) if rest.shape[-1] else out


def attention_route(is_cuda: bool, B: int, T: int, S: int, Dk: int, Dv: int, H: int,
                    Hkv: int, kv_dtype, ring: int = 0, scaled: bool = False,
                    sinks: bool = False, chunked: bool = False) -> str:
    """Which attention path a call takes: "flash_decode" (kernel E),
    "flash_attention" (kernel C) or "einsum". A kernel only on the card, and
    only where both the JAX package's gate (flash_decode_supported,
    flash_supported) and the shapes the kernel builds (flash_decode_builds,
    flash_builds) hold; every other shape, and every call on the CPU, takes
    the einsum path. kv_dtype is the cache's (int8 for the q8 cache, whose
    views C and the einsum path read dequantized).

    A ring bank (``ring`` = S) is the port's own route, as the JAX package
    sends every ring call to its einsum path: E where its gate less the
    view's conditions holds (flash_decode_ring_supported, under
    TPULLM_FLASH_DECODE), else C wherever it builds over the ring (any T).

    ALiBi is the port's own route as well: the JAX gates add
    ``cfg.alibi_max_bias == 0`` (llama.py:268-279), which sends every ALiBi
    call to the einsum path; here C and E take the slopes as one more term
    on each score and the route is the shapes' alone (check_dense keeps
    ALiBi away from windows, rings and softcaps).

    Head dim 64 (gpt-oss) on E is the port's own route too: the JAX gate
    asks Dk % 128 == 0 (flash_decode.py:254), which sends it to the einsum
    path; here E builds D = 64 and takes it where the JAX gate's other
    conditions hold (flash_decode_own_supported).

    ``scaled``: the call brings a scale of its own (MLA's mla_scale), which
    keeps it off C by the JAX prefill gate (``scale is None``,
    llama.py:268) and off E, which the port builds with the config's scale
    alone, whatever the shapes: the einsum path.

    ``sinks``: the call's layer carries attention sinks (gpt-oss, mimo2),
    which keep it off C, plain or ring, by the JAX prefill gate (``sinks is
    None``, llama.py:268): C has no sink. E takes them (its last merge adds
    each head's sink to the denominator), so the decode route is unchanged.

    ``chunked``: the call's layer has llama4's chunked window, which C
    builds over a plain view (flash_builds): the port's own route again.
    The JAX prefill gate sends such a layer to its C only where the window
    is static (llama.py:268-275), and that kernel masks it as a sliding
    window (flash_attention.py:61-64); its einsum path, the oracle here,
    masks by chunk (llama.py:335-337), as C and E do. The dual cache builds
    no ring for chunked layers (KVCache.create), so no chunked call reads
    one."""
    if not is_cuda or scaled:
        return "einsum"
    if ring:  # E builds its ring for bf16 only: the int8 cache has no ring
        if (flash_decode_ring_supported(T, Dk, Dv) and kv_dtype == torch.bfloat16
                and flash_decode_builds(T, Dk, Dv, H, Hkv, kv_dtype)):
            return "flash_decode"
        if not sinks and flash_builds(T, S, Dk, Dv, H, Hkv, ring, chunked):
            return "flash_attention"
        return "einsum"
    if ((flash_decode_supported(B, T, S, Dk, Dv, Hkv)
         or flash_decode_own_supported(B, T, S, Dk, Dv, Hkv))
            and flash_decode_builds(T, Dk, Dv, H, Hkv, kv_dtype)):
        return "flash_decode"
    if (not sinks and flash_supported(T, S, Dk, Dv)
            and flash_builds(T, S, Dk, Dv, H, Hkv, chunked=chunked)):
        return "flash_attention"
    return "einsum"


def decode_route(cfg: ModelConfig, B: int, kv_view: int, kv_dtype, on_card: bool,
                 ring: int = 0, sinks: bool = False):
    """attention_route of one decode step (T = 1) of B rows over a kv view:
    the part of a captured decode step's key that TPULLM_FLASH_DECODE and
    the built shapes decide. With a ring (a dual cache) the pair (the full
    banks' route, the ring's route). An MLA step's attention is scaled by
    mla_scale over the compressed rows (kv_dims). ``sinks``: the model's
    layers carry attention sinks (``has_sinks``), which keep a ring step off
    C when E is off."""
    hkv, dk, dv = kv_dims(cfg)
    r = attention_route(on_card, B, 1, kv_view, dk, dv, cfg.n_head, hkv, kv_dtype, 0,
                        bool(cfg.kv_lora_rank), sinks)
    if not ring:
        return r
    return r, attention_route(on_card, B, 1, ring, cfg.head_dim, cfg.head_dim_v, cfg.n_head,
                              cfg.n_head_kv, kv_dtype, ring, False, sinks)


def has_sinks(params: dict) -> bool:
    """Whether any layer of a model's params carries attention sinks."""
    groups = params["layers"].get("__groups__") or [params["layers"]]
    return any("attn_sinks" in gl for gl in groups)


def attention(q, k_all, v_all, q_slots, kv_positions, positions, valid_from,
              cfg: ModelConfig, layer_is_swa: bool = False, kv_q8=None, ring: int = 0,
              scale: float | None = None, sinks=None):
    """q (B,T,H,Dk), k/v HEAD-MAJOR (B,Hkv,S,D*) -> (B,T,H,Dv).

    Slot mask valid_from[b] <= s <= q_slots[b, t]. The path is
    attention_route's: the JAX package's gates with "the tensors are on the
    card" in place of "the default backend is the TPU" (prefill kernel C,
    llama.py:268-274; decode kernel E, llama.py:277-294, off unless
    TPULLM_FLASH_DECODE is set), narrowed to the shapes each kernel builds;
    otherwise the einsum path with masks runs (the JAX package leaves it to
    XLA the same way).

    kv_q8: the raw int8 cache views (k, v, k scales, v scales), with k_all
    and v_all None. Kernel E reads them as they are; the other branches
    dequantize them here, so the dequantized views exist only where they
    are read (XLA drops the unused one; eager PyTorch would not).

    ring: k/v are a ring bank of that many slots (an SWA layer of the dual
    cache), masked by the ring mask (llama.py:313-324) in place of the slot
    and positional window masks.

    scale: the call's own scale in place of the config's (MLA's
    mla_scale), which sends it to the einsum path (attention_route).

    sinks: the layer's (H,) f32 sink logits (gpt-oss, mimo2), a device
    tensor read in place (so a captured step takes it): each head's sink
    joins its softmax as a key without a value (llama.py:342-348), on the
    einsum path and on kernel E; it keeps the call off kernel C.

    A window layer of a config with swa_chunked (llama4) masks by chunk,
    the key's position at least the query's floored to a multiple of the
    window (llama.py:335-337), on every route."""
    B, T, H, Dk = q.shape
    kref, vref = (kv_q8[0], kv_q8[1]) if kv_q8 is not None else (k_all, v_all)
    Hkv, S, Dv = kref.shape[1], kref.shape[2], vref.shape[-1]
    chunked = bool(cfg.swa_chunked and layer_is_swa and cfg.sliding_window)
    route = attention_route(q.is_cuda, B, T, S, Dk, Dv, H, Hkv, kref.dtype, ring,
                            scale is not None, sinks is not None, chunked)
    if route == "flash_decode":
        window = cfg.sliding_window if layer_is_swa else 0
        if kv_q8 is not None:
            kq, vq, ksc, vsc = kv_q8
            return flash_decode(q, kq, vq, q_slots, positions, valid_from, cfg, window,
                                sinks=sinks, k_scales=ksc, v_scales=vsc)
        return flash_decode(q, k_all, v_all, q_slots, positions, valid_from, cfg, window,
                            sinks=sinks, ring=ring)
    if kv_q8 is not None:
        k_all = dequant_view(kv_q8[0], kv_q8[2], q.dtype)
        v_all = dequant_view(kv_q8[1], kv_q8[3], q.dtype)
    if route == "flash_attention":
        return flash_attention(q, k_all, v_all, q_slots, kv_positions, positions,
                               valid_from, cfg, layer_is_swa, ring)
    cfg_scale, softcap, window = attention_params(cfg, layer_is_swa)
    return masked_attention(q, k_all, v_all, q_slots, kv_positions, positions,
                            valid_from, cfg_scale if scale is None else scale, softcap, window,
                            ring, alibi_of(cfg, q.device), sinks, chunked)


def gated_act(g, u, act: str, dtype):
    """The gated FFN's activation of gate g and up u (llama.py:624-635,
    431-440): silu, gelu (tanh approximation) or relu (smallthinker's
    experts) of g in f32, rounded to ``dtype``, times u; or gpt-oss's
    clamped SwiGLU (swiglu_oai) wholly in f32, min(g, 7) * sigmoid(1.702 *
    min(g, 7)) * (clip(u, -7, 7) + 1), then rounded."""
    gf = g.to(torch.float32)
    if act == "swiglu_oai":
        gf = torch.clamp(gf, max=7.0)
        uf = torch.clamp(u.to(torch.float32), -7.0, 7.0)
        return (gf * torch.sigmoid(1.702 * gf) * (uf + 1.0)).to(dtype)
    if act == "gelu":
        return torch.nn.functional.gelu(gf, approximate="tanh").to(dtype) * u
    if act == "relu":
        return torch.relu(gf).to(dtype) * u
    return torch.nn.functional.silu(gf).to(dtype) * u


def xielu(u, layer: int, cfg: ModelConfig, dtype):
    """apertus's xIELU of the ungated FFN's up u (llama.py:645-655;
    ggml-cpu's op_xielu) in f32 at layer ``layer``'s folded (alpha_n,
    alpha_p, beta, eps), each rounded to f32 as the JAX package's array holds
    it: alpha_p u^2 + beta u where u > 0, else alpha_n (expm1(min(u, eps)) -
    u) + beta u; rounded to ``dtype``. The parameters are Python floats, so a
    captured decode step holds them as constants."""
    a_n, a_p, b, eps = (float(np.float32(v)) for v in cfg.xielu[layer])
    uf = u.to(torch.float32)
    pos = a_p * uf * uf + b * uf
    neg = a_n * (torch.expm1(torch.clamp(uf, max=eps)) - uf) + b * uf
    return torch.where(uf > 0, pos, neg).to(dtype)


def ffn(x, qw, li, cfg: ModelConfig, dtype, lw=None, layer=None):
    """The dense FFN (llama.py:596-665): gated SiLU, GELU (tanh
    approximation) or swiglu_oai (``gated_act``) on fused (or separate)
    gate/up weights, or with
    cfg.ffn_gate off the ungated GELU, relu(u)**2 or xIELU (``xielu``, at
    the model's layer ``layer``, li where None) on up alone; the gate,
    up and down biases (lw: the layer's float tensors; jais's gate and up
    each on its half of the fused product) added in the compute dtype where
    the layer has them. BitNet's per-tensor scales (ffn_gate_s and ffn_up_s
    on the gated path, ffn_down_s) multiply their products in the compute
    dtype ahead of the biases, and its RMS sub-norm (ffn_sub_norm) takes the
    hidden before down (llama.py:616-619, 656-661). A GGUF-combined [gate;
    up] (an ffn_up of 2 x n_ff rows and no ffn_gate: phi3, chatglm, plamo3)
    takes one product, split at n_ff (llama.py:606-610); the loader renames
    it ffn_gateup where its halves fall on 256-column boundaries
    (ops/fuse.py). The JAX package reads xIELU's parameters at the index
    within the layer group, the model's where the depth is one group
    (ROADMAP §3)."""
    lw = lw or {}
    if not cfg.ffn_gate:
        u = qmm(x, qw["ffn_up"], dtype, li)
    else:
        g, u = gate_up(x, qw, li, cfg, dtype)
        if "ffn_gate_s" in lw:
            g = g * lw["ffn_gate_s"].to(dtype)
        if "ffn_up_s" in lw:
            u = u * lw["ffn_up_s"].to(dtype)
    if "ffn_gate_b" in lw:  # llama.py:620-621
        g = g + lw["ffn_gate_b"].to(dtype)
    if "ffn_up_b" in lw:
        u = u + lw["ffn_up_b"].to(dtype)
    if not cfg.ffn_gate and cfg.act_fn == "xielu":
        h = xielu(u, li if layer is None else layer, cfg, dtype)
    elif not cfg.ffn_gate:  # the activation of up itself
        uf = u.to(torch.float32)
        h = (torch.nn.functional.gelu(uf, approximate="tanh") if cfg.act_fn == "gelu"
             else torch.relu(uf) ** 2).to(dtype)
    else:
        h = gated_act(g, u, cfg.act_fn, dtype)
    if cfg.sub_norms and "ffn_sub_norm" in lw:
        h = rms_norm(h, lw["ffn_sub_norm"], cfg.rms_eps)
    out = qmm(h, qw["ffn_down"], dtype, li)
    if "ffn_down_s" in lw:
        out = out * lw["ffn_down_s"].to(dtype)
    if "ffn_down_b" in lw:
        out = out + lw["ffn_down_b"].to(dtype)
    return out


def gate_up(x, qw, li, cfg: ModelConfig, dtype):
    """The gated FFN's gate and up products (g, u): from the fused ffn_gateup
    (sliced at n_ff and at its 256-padded offset), a GGUF-combined [gate;
    up] ffn_up (split at n_ff) or separate ffn_gate and ffn_up."""
    if "ffn_gateup" in qw:
        y = qmm(x, qw["ffn_gateup"], dtype, li)
        return y[..., : cfg.n_ff], y[..., pad256(cfg.n_ff): pad256(cfg.n_ff) + cfg.n_ff]
    if "ffn_gate" not in qw:
        y = qmm(x, qw["ffn_up"], dtype, li)
        return y[..., : cfg.n_ff], y[..., cfg.n_ff: 2 * cfg.n_ff]
    return qmm(x, qw["ffn_gate"], dtype, li), qmm(x, qw["ffn_up"], dtype, li)


def per_layer_inputs(params: dict, cfg: ModelConfig, tokens, x, dtype):
    """gemma4's and gemma3n's per-layer token stream (llama.py:734-755;
    build_inp_per_layer + project_per_layer_inputs) -> (B, T, n_layer, P) in
    ``dtype``: the token's rows of the (vocab, n_layer x P) table times
    sqrt(P), and the projection of the embedded input x over sqrt(n_embd),
    RMS-normed per layer by per_layer_proj_norm, added and divided by
    sqrt(2). An id past the table's rows reads its last row, as the JAX
    take_rows of an unpadded table does (the published Gemma 3n vocabulary,
    262400, is larger than its table, 262144): the ids are clamped on the
    device, so no gather reads out of range."""
    B, T = tokens.shape
    P, L = cfg.n_embd_per_layer, cfg.n_layer
    table = params["per_layer_tok_embd"]
    ids = tokens.clamp(0, table.n_out - 1)
    ple = table.take_rows(ids, dtype).to(torch.float32).reshape(B, T, L, P) * math.sqrt(P)
    proj = qmm(x, params["per_layer_model_proj"], dtype).to(torch.float32) / math.sqrt(cfg.n_embd)
    proj = rms_norm(proj.reshape(B, T, L, P), params["per_layer_proj_norm"], cfg.rms_eps)
    return ((proj + ple) / math.sqrt(2.0)).to(dtype)


def per_layer_block(x, pli, qw, li, lw, cfg: ModelConfig, dtype):
    """The per-layer input block of gemma4's layers (llama.py:1042-1053) and
    of gemma3n's streams 1..A-1 (llama.py:1130-1139): gelu(x @ inp_gate) (in
    f32) times the layer's slice of the token stream ``pli`` (B, T, P),
    projected back to n_embd and RMS-normed by per_layer_post_norm, in f32
    (the caller adds it)."""
    g = torch.nn.functional.gelu(qmm(x.to(dtype), qw["per_layer_inp_gate"], dtype, li)
                                 .to(torch.float32), approximate="tanh")
    cur = qmm((g * pli.to(torch.float32)).to(dtype), qw["per_layer_proj"], dtype, li)
    return rms_norm(cur.to(torch.float32), lw["per_layer_post_norm"], cfg.rms_eps)


def altup_expand(x, proj, cfg: ModelConfig, dtype):
    """gemma3n's AltUp stream expansion (llama.py:756-766): the embedded
    input (B, T, D) and altup_n - 1 projections of it (altup_proj, (A - 1,
    D, D)), each rescaled to the input's per-token L2 norm -> the streams
    packed as (B, T, A * D)."""
    B, T, _ = x.shape
    xf = x.to(torch.float32)
    tm = torch.sqrt((xf * xf).sum(-1, keepdim=True))
    added = torch.einsum("btd,jkd->btjk", xf, proj.to(torch.float32))
    added = added * (tm[..., None] / torch.sqrt((added * added).sum(-1, keepdim=True)))
    return torch.cat([xf[..., None, :], added], dim=-2).reshape(B, T, -1).to(dtype)


def altup_merge(x, unembd, cfg: ModelConfig, dtype):
    """gemma3n's AltUp merge (llama.py:1531-1541): streams 1..A-1 projected
    back by altup_unembd_proj, each rescaled to the active stream's L2 norm,
    then the mean of stream 0 and them -> (B, T, D)."""
    A, D = cfg.altup_n, cfg.n_embd
    s = x.reshape(x.shape[0], x.shape[1], A, D).to(torch.float32)
    act = s[..., cfg.altup_act, :]
    tm = torch.sqrt((act * act).sum(-1, keepdim=True))
    un = torch.einsum("btjd,jkd->btjk", s[..., 1:, :], unembd.to(torch.float32))
    un = un * (tm[..., None] / torch.sqrt((un * un).sum(-1, keepdim=True)))
    return ((s[..., 0, :] + un.sum(-2)) / A).to(dtype)


def altup_layer(x, qw, li, lw, layer: int, pli, attend_wo, cfg: ModelConfig, dtype):
    """gemma3n's AltUp layer (llama.py:1071-1147; gemma3n.cpp:133-262), plain
    PyTorch ops on x's device beside the layer's products (kernels A and B).
    x packs altup_n residual streams as (B, T, A * D). The router's tanh
    modalities of the active stream predict each stream as a mix of all
    (altup_predict_coef, plus the stream); the active prediction runs the
    layer: attention (``attend_wo``: the attention's input -> its output
    after wo, a shared-KV layer's Q-only read included) with its post-norm,
    beside the rank-64 LAuReL bypass (laurel_l, laurel_r, its post-norm, plus
    the input), averaged by 1/sqrt(2); the gelu FFN, whose gate on the first
    n_layer_sparsity layers (``layer`` the index in the model) is cut at its
    per-token mean + std x sparsity_std_mul over n_ff (std over n_ff - 1)
    and relu'd; the FFN's post-norm. The innovation (the output less the
    prediction) corrects every stream by the modalities of the output
    (altup_correct_coef, plus 1), and the per-layer block of the corrected
    active stream (times altup_correct_scale) is added into streams 1..A-1.
    The f32 arrays (router, coefficients, LAuReL) take torch.matmul; the
    gate, up and down products come from a fused ffn_gateup as from
    separate weights (``gate_up``)."""
    A, D = cfg.altup_n, cfg.n_embd
    B, T, _ = x.shape
    f32 = torch.float32
    eps = cfg.rms_eps
    s = x.reshape(B, T, A, D).to(f32)

    def modalities(y):  # compute_router_modalities (gemma3n.cpp:402-410)
        ri = rms_norm(y, lw["altup_router_norm"], eps) / D
        return torch.tanh(ri @ lw["altup_router"].to(f32).t())

    cp = (modalities(s[..., cfg.altup_act, :]) @ lw["altup_predict_coef"].to(f32).t())
    preds = torch.einsum("btji,btid->btjd", cp.reshape(B, T, A, A), s) + s
    ap = preds[..., cfg.altup_act, :]
    h = rms_norm(ap, lw["attn_norm"], eps).to(dtype)
    hf = h.to(f32)
    lau = (hf @ lw["laurel_l"].to(f32).t()) @ lw["laurel_r"].to(f32).t()
    lau = rms_norm(lau, lw["laurel_post_norm"], eps) + hf
    att = rms_norm(attend_wo(h), lw["post_attn_norm"], eps)
    attn_laurel = (att.to(f32) + ap + lau) * float(1.0 / np.sqrt(2.0))
    g, u = gate_up(rms_norm(attn_laurel, lw["ffn_norm"], eps).to(dtype), qw, li, cfg, dtype)
    g, u = g.to(f32), u.to(f32)
    if layer < cfg.n_layer_sparsity:  # gaussian_topk (gemma3n.cpp:387-393)
        mean = g.mean(-1, keepdim=True)
        std = torch.sqrt(((g - mean) ** 2).sum(-1, keepdim=True) / (g.shape[-1] - 1))
        g = torch.relu(g - (mean + std * cfg.sparsity_std_mul))
    f = qmm((torch.nn.functional.gelu(g, approximate="tanh") * u).to(dtype), qw["ffn_down"],
            dtype, li)
    gated = rms_norm(f.to(f32), lw["post_ffn_norm"], eps) + attn_laurel
    cc = modalities(gated) @ lw["altup_correct_coef"].to(f32).t() + 1.0
    corrected = preds + (gated - ap)[..., None, :] * cc[..., None]
    fp = per_layer_block(corrected[..., cfg.altup_act, :] * lw["altup_correct_scale"].to(f32),
                         pli, qw, li, lw, cfg, dtype)
    corrected = torch.cat([corrected[..., :1, :], corrected[..., 1:, :] + fp[..., None, :]],
                          dim=-2)
    return corrected.to(dtype).reshape(B, T, A * D)


def top_k(probs, k: int):
    """Indices of the k largest along the last axis, ties to the lower
    index first, as jax.lax.top_k orders them (torch.topk on CUDA promises
    no order among equal values)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]


def moe_route(on_card: bool, rows: int, gate_w, up_w, down_w, D: int, used: int,
              biased: bool = False) -> str:
    """Which path the routed experts of a call take: "skip" (kernel A's
    expert-skip variant over the selected experts, decode: B*T <= 16),
    "ragged" (kernel F over expert-sorted rows, prefill) or "loop" (every
    expert, mask-combined). The JAX package's gates (llama.py:447-464) with
    "the tensors are on the card" in place of "the default backend is the
    TPU", each kernel only on the stacks it takes (the skip over at most
    MAX_SLOTS slots: min(E, rows * used) of the ``used`` experts a row
    selects); the CPU, and a stack a kernel does not take (a planar one),
    run the loop. A ``biased`` stack (gpt-oss's expert biases) takes the
    loop: off F as in the JAX gate (_ragged_moe_ok, llama.py:524), and off
    the skip, whose kernels add no bias (the JAX decode loop adds them in
    each expert's branch, llama.py:423-443)."""
    if not on_card or biased:
        return "loop"
    n_ff_e = gate_w.shape[-2]
    if rows <= 16:
        cap = min(gate_w.shape[-3], rows * used)
        ok = skip_supported(gate_w, D, cap) and skip_supported(up_w, D, cap) and skip_supported(
            down_w, n_ff_e, cap)
        return "skip" if ok else "loop"
    return "ragged" if _ragged_moe_ok(gate_w, up_w, down_w, D) else "loop"


def moe_ffn(x, qw, li, cfg: ModelConfig, dtype, gate_shexp=None, probs_b=None, bias=None,
            router_x=None):
    """Mixture-of-experts FFN (llama.py:371-515; build_moe_ffn contract,
    src/llama-graph.h:831), gated experts (SiLU, gpt-oss's swiglu_oai or
    smallthinker's relu: ``gated_act``).

    Router: logits = router_x @ gate_inp^T, router_x the FFN's input x
    unless given (smallthinker's router reads the residual stream ahead of
    ffn_norm, llama.py:381-383, 1273-1275) (+ the layer's f32 router bias
    ``bias["moe_gate_inp_b"]``, gpt-oss, llama.py:385-386) -> softmax|sigmoid,
    top-k, optional weight renorm and scale. ``bias`` also holds gpt-oss's
    per-expert biases (E, n) ``moe_{gate,up,down}_exps_b``: each is added to
    its expert's product in the compute dtype, the down bias before the
    expert's routing weight (llama.py:423-443); a biased stack takes the
    loop (``moe_route``). Each is a device tensor read in place, so a
    captured decode step takes it. ``probs_b`` (the layer's f32 (E,) selection
    bias moe_probs_b: ernie4_5-moe, glm4moe, deepseek2-ocr, dots1, ...) is
    added to the probabilities for the top-k choice only; the combine
    weights are gathered from the unbiased probabilities
    (llama.py:391-403). It is a device tensor read in place, so a captured
    decode step takes it. The experts take ``moe_route``'s path: on the
    card, decode (B*T <= 16) runs only the selected experts through kernel
    A's expert-skip variant (the JAX package's lax.cond, llama.py:447-454,
    moved onto the device; ops/moe_decode.py), prefill the ragged grouped
    GEMM (kernel F). Otherwise every expert is evaluated and mask-combined
    in expert order; an unselected expert's weight is exactly 0, so its
    term adds nothing and the sum is the skip's. On the CPU this is the JAX
    package's dense path off the TPU, each expert run on its selected rows
    only (``_moe_loop``).

    With n_group_experts (grovemoe) the top-k is chosen by sigmoid(logits)
    whatever the gating, and the combine weights stay the gating's
    probabilities (llama.py:394-397); the chunk-expert bank then runs on the
    routed experts' output and is added to it (``chunk_bank``).

    A shared expert (ffn_{gate,up,down}_shexp) runs on x beside them and is
    added last, scaled first by the per-token sigmoid gate of
    ``gate_shexp`` (the layer's f32 moe_gate_inp_shexp, qwen2moe) where
    given (llama.py:498-510)."""
    B, T, D = x.shape
    E, used = cfg.n_expert, cfg.n_expert_used
    bias = bias or {}
    router = qmm(x if router_x is None else router_x, qw["moe_gate_inp"], dtype,
                 li)[..., :E].to(torch.float32)
    if "moe_gate_inp_b" in bias:
        router = router + bias["moe_gate_inp_b"].to(torch.float32)[None, None, :E]
    if cfg.expert_gating == "sigmoid":
        probs = torch.sigmoid(router)
    else:
        probs = torch.softmax(router, dim=-1)
    sel = probs if probs_b is None else probs + probs_b.to(torch.float32)[None, None, :]
    if cfg.n_group_experts > 0:  # grovemoe: selection by sigmoid, weights by probs
        sel = torch.sigmoid(router)
    top_i = top_k(sel, used)  # (B, T, used)
    w = torch.gather(probs, -1, top_i)
    if cfg.expert_weights_norm:
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    w = w * cfg.expert_weights_scale
    gate_w, up_w, down_w = qw["moe_gate_exps"], qw["moe_up_exps"], qw["moe_down_exps"]
    exp_b = {k: bias[k] for k in EXPERT_BIAS_KEYS if k in bias}
    route = moe_route(x.is_cuda, B * T, gate_w, up_w, down_w, D, used, bool(exp_b))
    act = lambda g, u: gated_act(g, u, cfg.act_fn, dtype)
    if route == "skip":
        out = moe_decode(x, w, top_i, gate_w, up_w, down_w, li, E, dtype, act)
    elif route == "ragged":
        out = _moe_prefill_ragged(x, w, top_i, gate_w, up_w, down_w, li, cfg, dtype)
    else:
        out = _moe_loop(x, w, top_i, gate_w, up_w, down_w, li, E, dtype, act, exp_b)
    if cfg.n_group_experts > 0 and "moe_gate_chexps" in qw:
        out = chunk_bank(out, probs, top_i, qw, li, cfg, dtype)
    if "ffn_gate_shexp" in qw:
        g = qmm(x, qw["ffn_gate_shexp"], dtype, li)
        u = qmm(x, qw["ffn_up_shexp"], dtype, li)
        h = torch.nn.functional.silu(g.to(torch.float32)).to(dtype) * u
        sh = qmm(h, qw["ffn_down_shexp"], dtype, li)
        if gate_shexp is not None:
            sg = torch.sigmoid(torch.einsum("btd,d->bt", x.to(torch.float32),
                                            gate_shexp.to(torch.float32)))
            sh = sh * sg[..., None].to(sh.dtype)
        out = out + sh
    return out


def chunk_bank(out, probs, top_i, qw, li, cfg: ModelConfig, dtype):
    """grovemoe's adjugate chunk experts (llama.py:466-493; grovemoe.cpp):
    E // n_group_experts SiLU experts, chunk c the group of routed experts
    [c * g, (c + 1) * g). Each row's chunk ids are its first min(used, E //
    g) picks // g, so two picks of one group name one chunk twice, and the
    chunk's weight is then the sum of both, as the JAX mask-sum adds them.
    The weights are the router's probabilities read at the chunk ids (the
    full-expert row indexed with chunk indices, as the reference does),
    renormalized and scaled as the routed experts' are. The bank reads the
    routed experts' output ``out`` (B, T, D) and returns out + its output x
    expert_group_scale. Its stacks take ``moe_route``'s path: the skip at
    decode and kernel F at prefill where all three are K-major stacks those
    kernels take, else the loop over every chunk (a planar chunk down)."""
    g = cfg.n_group_experts
    E_ch = cfg.n_expert // g
    gate_w, up_w, down_w = (qw[k] for k in ("moe_gate_chexps", "moe_up_chexps",
                                            "moe_down_chexps"))
    if gate_w.shape[-3] != E_ch:
        raise NotImplementedError(
            f"moe_gate_chexps {tuple(gate_w.shape)}: {gate_w.shape[-3]} chunk experts, the "
            f"graph reads {cfg.n_expert} // {g} = {E_ch}")
    used_ch = min(cfg.n_expert_used, E_ch)
    chunk_i = top_i[..., :used_ch] // g
    w = torch.gather(probs, -1, chunk_i)
    if cfg.expert_weights_norm:
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    w = w * cfg.expert_weights_scale
    B, T, D = out.shape
    route = moe_route(out.is_cuda, B * T, gate_w, up_w, down_w, D, used_ch)
    if route == "skip":
        adj = moe_decode(out, w, chunk_i, gate_w, up_w, down_w, li, E_ch, dtype)
    elif route == "ragged":
        adj = _moe_prefill_ragged(out, w, chunk_i, gate_w, up_w, down_w, li,
                                  dataclasses.replace(cfg, n_expert=E_ch, act_fn="silu"), dtype)
    else:
        adj = _moe_loop(out, w, chunk_i, gate_w, up_w, down_w, li, E_ch, dtype)
    return out + adj * cfg.expert_group_scale


def _moe_loop(x, w, top_i, gate_w, up_w, down_w, li, E: int, dtype, act=None, bias=None):
    """Every expert on every row, each weighted by the rows' routing weight
    of it (exactly 0 where unselected), summed in expert order. ``act`` (g,
    u) -> h, SiLU where None; ``bias``: the layer's expert biases (E, n) by
    key, each added to its product (llama.py:423-443).

    On the CPU, where the routing can be read on the host, an expert that no
    row selects is not run (it would add an exact 0, and the JAX decode's
    lax.cond skips it too, llama.py:447-454); past MAX_ROWS rows (a prefill)
    each expert runs on the rows that select it alone, each row's sum taken
    in the same expert order (a row's product may round otherwise in its
    last bits: another BLAS blocking). Up to MAX_ROWS rows an expert runs on
    every row, so the sum stays the skip's bit for bit (ops/moe_decode.py).
    On the card every expert runs on every row: a captured step reads no
    routing on the host."""
    bias = bias or {}
    act = act or (lambda g, u: gated_act(g, u, "silu", dtype))

    def plus(y, key, e):
        return y + bias[key][e].to(dtype) if key in bias else y

    def product(xe, e):
        ue = plus(_expert_mm(xe, up_w, li, e, dtype), "moe_up_exps_b", e)
        ge = plus(_expert_mm(xe, gate_w, li, e, dtype), "moe_gate_exps_b", e)
        return plus(_expert_mm(act(ge, ue), down_w, li, e, dtype), "moe_down_exps_b", e)

    def one_expert(e):
        we = (w * (top_i == e)).sum(-1)  # (B, T)
        return product(x, e) * we[..., None].to(dtype)

    if x.is_cuda:
        out = one_expert(0)
        for e in range(1, E):
            out = out + one_expert(e)
        return out
    B, T, D = x.shape
    flat_i, flat_w = top_i.reshape(B * T, -1), w.reshape(B * T, -1)
    present = torch.unique(flat_i).tolist()
    if B * T <= MAX_ROWS:
        out = one_expert(present[0])
        for e in present[1:]:
            out = out + one_expert(e)
        return out
    flat_x, out = x.reshape(1, B * T, D), None
    for e in present:
        rows = (flat_i == e).any(-1).nonzero().flatten()
        de = product(flat_x[:, rows], e)[0]
        we = (flat_w[rows] * (flat_i[rows] == e)).sum(-1)
        if out is None:
            out = torch.zeros((B * T, de.shape[-1]), dtype=de.dtype)
        out[rows] = out[rows] + de * we[:, None].to(dtype)
    return out.reshape(B, T, -1)


def _ragged_moe_ok(gate_w, up_w, down_w, D) -> bool:
    from ..ops.moe_gmm import gmm_supported

    return (gmm_supported(gate_w, D) and gmm_supported(up_w, D)
            and gmm_supported(down_w, gate_w.shape[-2]))


def _moe_prefill_ragged(x, w, top_i, gate_w, up_w, down_w, li, cfg: ModelConfig, dtype):
    """Sorted-by-expert grouped MoE FFN (llama.py:531-563, ops/moe_gmm.py).

    The JAX package combines with a scatter-add over the sorted rows
    (``out.at[tok_s].add``), which CUDA would run with atomics in no fixed
    order. Here each token's ``used`` rows are gathered through the inverse
    permutation and summed in slot order from 0, the same sums bit for bit
    at top-2 and deterministic at any k."""
    from ..ops.moe_gmm import grouped_qmm, live_tiles, sort_by_expert

    B, T, D = x.shape
    M = B * T
    used = top_i.shape[-1]
    xf = x.reshape(M, D).to(torch.bfloat16)
    order, dest, tile_expert, Mp = sort_by_expert(top_i.reshape(M, used), cfg.n_expert, M)
    tok_s = order // used  # source token of each sorted assignment
    live = live_tiles(dest, tile_expert, Mp)
    xs_pad = torch.zeros((Mp, D), dtype=torch.bfloat16, device=x.device)
    xs_pad[dest] = xf[tok_s]
    n_ff_e = gate_w.shape[-2]
    g = grouped_qmm(xs_pad, tile_expert, gate_w, n_ff_e, layer=li, live=live)
    u = grouped_qmm(xs_pad, tile_expert, up_w, n_ff_e, layer=li, live=live)
    # in f32, as llama.py:547-557 (whose relu falls to its silu branch: the
    # JAX ragged path runs only on the TPU, its CPU loop takes relu)
    h = gated_act(g, u, cfg.act_fn, torch.float32)
    y = grouped_qmm(h.to(torch.bfloat16), tile_expert, down_w, D, layer=li, live=live)
    row_of = torch.empty_like(dest)  # padded row of assignment m * used + j
    row_of[order] = dest
    contrib = (y[row_of].to(torch.float32) * w.reshape(M * used, 1)).reshape(M, used, D)
    out = torch.zeros((M, D), dtype=torch.float32, device=x.device)
    for j in range(used):
        out = out + contrib[:, j]
    return out.reshape(B, T, D).to(dtype)


def expert_weight(qt: QTensor, li, e: int) -> QTensor:
    """Expert e of layer li of a stacked (L, E, n, k) QTensor, as views."""
    data = qt.data if li is None else {k: v[li] for k, v in qt.data.items()}
    return QTensor(qt.qtype, tuple(qt.shape[-2:]), {k: v[e] for k, v in data.items()})


def _expert_mm(x, qt: QTensor, li, e: int, dtype):
    """x @ W_e^T for expert e of a stacked (L, E, n, k) QTensor (kernel A
    or B on the card for K-major weights)."""
    return qmm(x, expert_weight(qt, li, e), dtype)


# an MLA layer's attention (runtime/loader.py's names): the q path (wq or its
# low-rank pair wq_a/wq_b with the norm between), the joint kv projection and
# the latent's norm, and the absorption banks wk_b (H, kv_lora, nope) and
# wv_b (H, v, kv_lora) as dense f32
MLA_KEYS = frozenset({"wq_a", "q_a_norm", "wq_b", "wkv_a", "kv_a_norm", "wk_b", "wv_b"})
# the layernorm archs' biases of the stream norms
NORM_BIAS_KEYS = frozenset({"attn_norm_b", "ffn_norm_b", "attn_norm_2_b"})
# bitnet's RMS sub-norms (on the attention output before wo, on the FFN's
# hidden before down) and its per-tensor (1,) output scales (llama.py:616-619,
# 656-661, 1222-1225, 1256-1263)
SUB_NORM_KEYS = frozenset({"attn_sub_norm", "ffn_sub_norm"})
ATTN_SCALE_KEYS = frozenset({"wq_s", "wk_s", "wv_s"})
SCALE_KEYS = ATTN_SCALE_KEYS | {"wo_s", "ffn_gate_s", "ffn_up_s", "ffn_down_s"}
_LAYER_KEYS = (frozenset({"attn_norm", "ffn_norm", "wqkv", "wq", "wk", "wv", "wo",
                          "ffn_gateup", "ffn_gate", "ffn_up", "ffn_down", "wqkv_cat",
                          "bqkv_cat", "bq", "bk", "bv", "q_norm", "k_norm", "q_norm_b",
                          "k_norm_b", "post_attn_norm", "post_ffn_norm", "moe_gate_inp_shexp",
                          "attn_norm_2", "bo", "ffn_up_b", "ffn_down_b", "ffn_gate_b",
                          "moe_probs_b", "wqkv_gate", "attn_sinks", "ffn_norm_exps",
                          "out_scale"})
               | MOE_KEYS | SHEXP_KEYS | NORM_BIAS_KEYS | MLA_KEYS | MOE_BIAS_KEYS | CHEXP_KEYS
               | PLE_KEYS | ALTUP_KEYS | SUB_NORM_KEYS | SCALE_KEYS)


def check_ffn_layout(cfg: ModelConfig, gl) -> None:
    """Raise NotImplementedError where a dense gated FFN has none of its
    weight layouts: the load-time fused ffn_gateup, separate ffn_gate and
    ffn_up, or a GGUF-combined [gate; up] (an ffn_up of 2 x n_ff rows,
    llama.py:606-610); and where a layer has no ffn_down. Ungated FFNs are
    not asked, nor layers with routed experts, but for the dense FFN beside
    them: arctic's, which its block always runs, and grok's where the layer
    has one (llama.py:1295-1314)."""
    moe = cfg.n_expert > 0 and "moe_gate_inp" in gl
    if not cfg.ffn_gate or (moe and cfg.moe_dense_parallel != "arctic"
                            and not DENSE_FFN_KEYS & set(gl)):
        return
    up = gl.get("ffn_up")
    ok = ("ffn_gateup" in gl or ("ffn_gate" in gl and up is not None)
          or ("ffn_gate" not in gl and up is not None and up.n_out == 2 * cfg.n_ff))
    if not ok or "ffn_down" not in gl:
        have = {k: tuple(gl[k].shape) for k in ("ffn_gateup", "ffn_gate", "ffn_up", "ffn_down")
                if k in gl}
        raise NotImplementedError(
            f"FFN tensors {have} (n_ff {cfg.n_ff}): the gated FFN needs ffn_down and "
            "ffn_gateup, ffn_gate with ffn_up, or an ffn_up of 2 x n_ff rows")


def check_attn_gate(cfg: ModelConfig, gl) -> None:
    """The attention output gate (wqkv_gate, llama.py:1231-1245) is step35's
    per-head projection (n_head rows, one sigmoid a head) or afmoe's as wide
    as the attention output (n_head x head_dim_v rows, one a column); a gate
    of any other width raises."""
    gate = gl.get("wqkv_gate")
    if gate is not None and gate.n_out not in (cfg.n_head, cfg.n_head * cfg.head_dim_v):
        raise NotImplementedError(
            f"wqkv_gate {tuple(gate.shape)}: the attention gate is per head ({cfg.n_head} "
            f"rows, step35) or as wide as the attention output ({cfg.n_head * cfg.head_dim_v} "
            "rows, afmoe)")


def _unread_tensors(cfg: ModelConfig, gl) -> list[str]:
    """Layer tensors this config's graph would not read (the JAX package
    ignores them; the port raises rather than drop weights): among them the
    shared expert, the router's selection bias, the router's bias and the
    expert biases of a layer without routed experts, and the shared
    expert's gate without the shared expert; norm
    biases without layernorm; attn_norm_2 without the parallel block, and ffn_norm or
    post_ffn_norm in a parallel block that does not read them; gate
    weights and the gate's bias on an ungated FFN; the dense FFN's biases on
    a MoE layer, and its weights there outside grok's and arctic's blocks;
    the chunk experts without n_group_experts or routed experts, and
    ffn_norm_exps outside arctic's MoE layers; q/k norm biases outside flat
    layernorm q/k norms (mpt); the
    MLA tensors without kv_lora_rank, the low-rank q pair without
    q_lora_rank, and on an MLA layer the separate or fused k/v projections
    and wq beside the low-rank pair; the attention output gate without
    attn_gate_proj; q/k norm biases outside chameleon's layernorm QK norm and
    the flat layernorm ones; BitNet's sub-norms and scales without sub_norms
    (which check_dense keeps off MoE, MLA and AltUp layers), its k/v scales
    without wq_s and its gate and up scales on an ungated FFN."""
    unread = {"bq", "bk", "bv"} if not cfg.attn_bias else set()
    if not cfg.attn_gate_proj:
        unread.add("wqkv_gate")
    if not cfg.kv_lora_rank:
        unread |= MLA_KEYS
    else:
        unread |= {"wk", "wv", "wqkv", "wqkv_cat", "bqkv_cat", "bo", "wqkv_gate"}
        if "wq_a" in gl:
            unread.add("wq")
    if not cfg.q_lora_rank:
        unread |= {"wq_a", "q_a_norm", "wq_b"}
    if not (cfg.attn_qk_norm or cfg.attn_qk_norm_flat):
        unread |= {"q_norm", "k_norm"}
    if not ((cfg.attn_qk_norm_flat and cfg.norm_type == "layernorm")
            or (cfg.attn_qk_norm and cfg.qk_norm_type == "layernorm")):
        unread |= {"q_norm_b", "k_norm_b"}
    if not cfg.sub_norms:
        unread |= SUB_NORM_KEYS | SCALE_KEYS
    if "wq_s" not in gl:
        unread |= ATTN_SCALE_KEYS
    if not cfg.post_norms:
        unread |= {"post_attn_norm", "post_ffn_norm"}
    if not cfg.pre_norm:
        unread |= {"attn_norm", "ffn_norm", "attn_norm_b", "ffn_norm_b"}
    if cfg.norm_type != "layernorm":
        unread |= NORM_BIAS_KEYS
    if not cfg.parallel_residual:
        unread |= {"attn_norm_2", "attn_norm_2_b"}
    else:  # llama.py:1280-1290: attn_norm_2, else ffn_norm, else h
        unread.add("post_ffn_norm")
        if "attn_norm_2" in gl:
            unread |= {"ffn_norm", "ffn_norm_b"}
    if not cfg.ffn_gate:
        unread |= {"ffn_gate", "ffn_gateup", "ffn_gate_b", "ffn_gate_s", "ffn_up_s"}
    moe = cfg.n_expert > 0 and "moe_gate_inp" in gl
    if moe:
        unread |= {"ffn_up_b", "ffn_down_b", "ffn_gate_b"}
        if not cfg.moe_dense_parallel:
            unread |= DENSE_FFN_KEYS
    else:
        unread |= SHEXP_KEYS | MOE_BIAS_KEYS | {"moe_gate_inp_shexp", "moe_probs_b"}
    if not (moe and cfg.n_group_experts > 0):
        unread |= CHEXP_KEYS
    if not (moe and cfg.moe_dense_parallel == "arctic"):
        unread.add("ffn_norm_exps")
    if "ffn_gate_shexp" not in gl:
        unread.add("moe_gate_inp_shexp")
    if not cfg.n_embd_per_layer:
        unread |= PLE_KEYS
    if not cfg.altup_n:
        unread |= ALTUP_KEYS
    else:  # the AltUp layer applies no output scale (llama.py:1071-1147)
        unread.add("out_scale")
    return sorted(unread & set(gl))


def check_stream_tables(params: dict, cfg: ModelConfig) -> None:
    """Raise NotImplementedError where the per-layer token stream's tables
    or AltUp's projections do not match the config: each set present exactly
    where the config reads it (n_embd_per_layer, altup_n), as the JAX
    forward reads them (llama.py:734-766)."""
    for tables, on, field in ((PLE_TABLES, cfg.n_embd_per_layer, "n_embd_per_layer"),
                              (ALTUP_TABLES, cfg.altup_n, "altup_n")):
        have = [k for k in tables if k in params]
        if (have and not on) or (on and len(have) < len(tables)):
            raise NotImplementedError(
                f"tables {have} with {field}={on}: the config reads all of {list(tables)} "
                "or none")


def check_shared_group(cfg: ModelConfig, gl, off: int, L_g: int) -> bool:
    """Whether layers [off, off + L_g) of a group are shared-KV layers (from
    kv_owners on), which must hold Q alone (wq, no K or V projection), while
    an owning layer holds its K projection; a group may not straddle the
    first shared layer. The JAX forward tells them by their tensors
    (llama.py:1396-1398); the loader gives them a group of their own."""
    n_kv = kv_owners(cfg)
    shared = off >= n_kv
    kv = {"wk", "wv", "wqkv", "wqkv_cat", "k_norm", "bk", "bv", "bqkv_cat"} & set(gl)
    if off < n_kv < off + L_g or (shared and (kv or "wq" not in gl)) or (
            not shared and cfg.gemma4_attn and not kv & {"wk", "wqkv", "wqkv_cat"}):
        raise NotImplementedError(
            f"layers [{off}, {off + L_g}) with {sorted(kv) or 'no K/V projection'}: the first "
            f"{n_kv} layers own the cache and hold K, the shared-KV layers after them Q alone")
    return shared


def layer_routes(cfg: ModelConfig, gl, qw, B: int, T: int, on_card: bool,
                 n_groups: int) -> tuple[bool, bool]:
    """(use_block, use_fold) of one layer group: the JAX package's gates
    (llama.py:1382-1397, 1416-1423) with "the tensors are on the card" in
    place of "the default backend is the TPU". The layer kernel runs a
    decode step's wo, post-attention residual, ffn_norm and FFN; it takes
    no bias (q/k/v, bo, the FFN's or ffn_norm's), no attn_norm_2 and no
    flat q/k norm (the QK norm per head runs in attention, on the QKV rows
    the kernel emits); its own gate (block_supported) closes it to
    layernorm, the parallel block and the ungated FFN. Folded, it also
    emits the next layer's norm and fused QKV; not with NoPE layers
    (no_rope_interval), as in the JAX gate (llama.py:1422).

    Two conditions are the port's own: the kernel adds its residuals
    unscaled and its wo product as it is, so a residual_scale other than 1
    (granite, minicpm) and mimo2's value scale (attn_out_scale) keep the
    layer off it. The JAX gate asks neither (ops/layer_kernel.py:410-428,
    llama.py:1382-1397), so on the TPU those layers' decode would drop the
    scale. MLA layers stay off it, as
    in the JAX gate (``kv_lora_rank == 0``, llama.py:1395), and so does
    gemma3n's AltUp layer (``not cfg.altup_n``, llama.py:1396). The layer
    kernel ends at the FFN's residual, so a layer with gemma4's per-layer
    input block or output scale stays off it too: the port's own condition,
    where the JAX gate keeps such layers off by ``post_norms`` alone
    (ops/layer_kernel.py:413), which both gemma rows set. BitNet's sub-norms
    and per-tensor scales keep a layer off the kernel and the fold, another
    of the port's own conditions: the kernel runs wo, gate/up and down as
    they are, and the JAX gate asks for none of them (llama.py:1382-1397,
    ops/layer_kernel.py:409-428), while its kernel branch returns before the
    attention sub-norm and wo's scale (llama.py:1246-1263), so a TPU decode of
    a bitnet file there drops them (ROADMAP §3).

    The combined [gate; up] of a phi3 or chatglm file takes the kernel on the
    port's own route: where n_ff is a multiple of 256 the loader renames the
    combined ffn_up ffn_gateup (byte for byte the fused layout,
    ops/fuse.py:fuse_layer_weights), which block_supported asks for, as the
    JAX gate does (ops/layer_kernel.py:411). The JAX loader keeps the
    combined tensor as ffn_up, so there such layers take the plain FFN."""
    use_block = (B * T <= 16 and on_card and cfg.kv_lora_rank == 0 and not cfg.altup_n
                 and "ffn_norm" in gl and "ffn_norm_b" not in gl
                 and not any(k in gl for k in ("bo", "ffn_up_b", "ffn_down_b", "ffn_gate_b",
                                               "attn_norm_2", "per_layer_inp_gate",
                                               "out_scale", *SUB_NORM_KEYS, *SCALE_KEYS))
                 and not cfg.attn_bias and not cfg.attn_qk_norm_flat
                 and cfg.residual_scale == 1.0 and not cfg.attn_out_scale
                 and block_supported(cfg, qw))
    use_fold = (use_block and "wqkv" in qw and n_groups == 1 and "attn_norm" in gl
                and not cfg.no_rope_interval)
    return use_block, use_fold


def forward(params: dict, cfg: ModelConfig, tokens, positions, cache: KVCache,
            cache_pos, valid_from, dtype=torch.bfloat16, kv_view_len=None, slot0=None,
            logits_idx=None):
    """Returns (logits (B, T, vocab) f32, cache), the cache updated in place.

    tokens/positions (B, T) int; valid_from (B,) is each row's first valid
    slot; kv_view_len bounds the cache slots attention reads. Layouts
    (llama.py:697-703, 769-775):
    - batch engine: an int ``cache_pos``, every row writes slots
      [cache_pos, cache_pos + T) (left-padded rows share slot indices); its
      decode step passes a (B,) tensor with every row at the same slot
      instead, so that a captured step reads the slot from the device;
    - server slots: ``slot0`` (int) selects cache batch rows
      [slot0, slot0 + B), so a one-sequence prefill writes just its slot; a
      (B,) tensor ``cache_pos`` gives each row its own first slot (rows at
      different depths).
    Each layer's K/V rows go to the cache in one ``kv_store`` (on the card
    its CUDA kernel, K and V together, quantized on the int8 cache; an int
    cache_pos becomes a (B,) tensor first). Writes past the cache's last
    slot are dropped, as the JAX scatter drops them (a bucketed prefill
    chunk near the end). On the dual cache each layer reads and writes its
    own bank (``bank_map``): an SWA layer stores at q_slots % ring and
    attends over its whole ring, never cut to kv_view_len (llama.py:825-826,
    894, 913); T must then be <= ring - window.
    ``logits_idx`` (int) computes the lm_head for that position only
    (logits (B, 1, vocab)). A learned position table (``pos_embd``) is
    gathered at ``positions`` on the device (no host read, so a captured
    step takes it), clamped to its last row: only padding and overshoot
    positions reach past it, since InferenceEngine and ServerContext refuse
    a context longer than the table (check_positions)."""
    groups = params["layers"].get("__groups__") or [params["layers"]]
    moe = [MOE_KEYS & set(gl) for gl in groups]
    if any(m and m != MOE_KEYS for m in moe):
        raise NotImplementedError(f"MoE layers need all of {sorted(MOE_KEYS)}")
    for keys, name, what in ((SHEXP_KEYS, "shared expert", "the gated shared expert"),
                             (CHEXP_KEYS, "chunk expert", "the chunk-expert bank")):
        have = [keys & set(gl) for gl in groups]
        if any(h and h != keys for h in have):
            raise NotImplementedError(f"{name} tensors {sorted(set().union(*have))}: {what} "
                                      f"needs all of {sorted(keys)}")
    check_dense(cfg, moe=any(moe))
    banks = bank_map(cfg, cache.dual)
    B, T = tokens.shape
    b0 = 0 if slot0 is None else int(slot0)
    if not 0 <= b0 <= cache.k.shape[1] - B:
        raise ValueError(f"cache rows [{b0}, {b0 + B}) outside the cache's {cache.k.shape[1]}")
    dev = tokens.device
    x = params["tok_embd"].take_rows(tokens, dtype)
    if cfg.embedding_scale != 1.0:  # llama.py:713-714
        x = (x.to(torch.float32) * cfg.embedding_scale).to(dtype)
    if "pos_embd" in params:  # learned absolute positions (llama.py:715-717)
        table = params["pos_embd"]
        x = x + torch.nn.functional.embedding(positions.clamp(max=table.shape[0] - 1),
                                              table).to(dtype)
    if "tok_norm" in params:  # bloom's layernorm on the embedding (llama.py:718-720)
        x = _norm(x, params["tok_norm"], params.get("tok_norm_b"), cfg)
    check_stream_tables(params, cfg)
    # the per-layer token stream (B, T, n_layer, P) and AltUp's streams
    # (llama.py:734-766): device ops on the device tokens, so a captured
    # step takes them
    pli = per_layer_inputs(params, cfg, tokens, x, dtype) if cfg.n_embd_per_layer else None
    if cfg.altup_n:
        x = altup_expand(x, params["altup_proj"], cfg, dtype)
    # cast once here rather than in each apply_rope (same values: q and k
    # are in the compute dtype); none without RoPE
    cos = sin = None
    if cfg.use_rope:
        cos, sin = (t.to(dtype) for t in rope_cache(cfg, positions))
    # SWA layers rope at their own base where the file gives one
    # (llama.py:722-731, 860-863)
    cos_swa, sin_swa = cos, sin
    if cfg.use_rope and cfg.rope_base_swa and cfg.rope_base_swa != cfg.rope_base:
        cfg_swa = dataclasses.replace(cfg, rope_base=cfg.rope_base_swa, raw_kv={})
        cos_swa, sin_swa = (t.to(dtype) for t in rope_cache(cfg_swa, positions))
    rope_swa = swa_flags(cfg)
    windows = layer_windows(cfg)
    nope = nope_flags(cfg)
    # the NoPE layers' query temperature (B, T, 1, 1), from the device positions
    temp = attn_temperature(cfg, positions)[..., None, None] if any(nope) else None
    S = cache.max_len
    L_view = kv_view_len if (kv_view_len is not None and kv_view_len < S) else S
    if torch.is_tensor(cache_pos):
        first = cache_pos.to(device=dev, dtype=torch.int64)
    else:
        first = torch.full((B,), int(cache_pos), dtype=torch.int64, device=dev)
    q_slots = first[:, None] + torch.arange(T, device=dev)[None, :]
    kv_positions = torch.arange(S, device=dev)[None, :] - valid_from[:, None]
    H, Hkv, hd, hdv = cfg.n_head, cfg.n_head_kv, cfg.head_dim, cfg.head_dim_v
    nq, nk, nv = H * hd, Hkv * hd, Hkv * hdv
    ok, ov = pad256(nq), pad256(nq) + pad256(nk)
    scale_mla = mla_scale(cfg) if cfg.kv_lora_rank else None

    def view(bank):
        """This ubatch's cache rows, first L_view slots (_view, llama.py:820-831)."""
        return bank[b0: b0 + B, :, :L_view]

    def attend(q, k, v, li, lw):
        """Flat q/k/v rows -> attention output (B, T, H * hdv), this layer's
        K/V stored (_attend_qkv, llama.py:833-910). lw: the layer's float
        tensors, among them its q/k norm weights, over the flat rows
        (attn_qk_norm_flat: the stream's norm type with q_norm_b/k_norm_b, as
        in the JAX package, llama.py:837-838) or per head (RMS), before RoPE
        or after it (qk_norm_post_rope). No RoPE where use_rope is off
        (llama.py:856-857). A NoPE layer (nope_flags) takes no RoPE, none of
        the norms after it and its query times the temperature; the others
        take llama4's weightless L2 QK norm after RoPE (qk_l2_norm,
        llama.py:869-885). chameleon's per-head QK norm before RoPE is a
        layernorm over the head dim with (H, hd) weights and biases at
        norm_eps, or 1e-5 where the file gives none (qk_norm_type,
        llama.py:843-850); it runs here, on the q/k rows of every route (the
        QKV rows of D's folded launch too). clamp_kqv clamps q, k and v after
        RoPE (llama.py:889-892). The layer's sink logits (attn_sinks, gpt-oss
        and mimo2, on every layer or some) go to attention (llama.py:922)."""
        qn, kn = lw.get("q_norm"), lw.get("k_norm")
        if cfg.attn_qk_norm_flat:
            q = _norm(q, qn, lw.get("q_norm_b"), cfg)
            k = _norm(k, kn, lw.get("k_norm_b"), cfg)
        q, k = q.reshape(B, T, H, hd), k.reshape(B, T, Hkv, hd)
        if cfg.attn_qk_norm and not cfg.qk_norm_post_rope:
            if cfg.qk_norm_type == "layernorm":
                eps = cfg.norm_eps or 1e-5
                q = layer_norm(q, qn, lw.get("q_norm_b"), eps)
                k = layer_norm(k, kn, lw.get("k_norm_b"), eps)
            else:
                q, k = rms_norm(q, qn, cfg.rms_eps), rms_norm(k, kn, cfg.rms_eps)
        if nope[li]:
            q = (q.to(torch.float32) * temp).to(q.dtype)
        else:
            if cfg.use_rope:
                c, sn = (cos_swa, sin_swa) if rope_swa[li] else (cos, sin)
                q = apply_rope(q, c, sn, cfg.rope_type, cfg.rope_dim)
                k = apply_rope(k, c, sn, cfg.rope_type, cfg.rope_dim)
            if cfg.attn_qk_norm and cfg.qk_norm_post_rope:
                q, k = rms_norm(q, qn, cfg.rms_eps), rms_norm(k, kn, cfg.rms_eps)
            if cfg.qk_l2_norm:
                q, k = rms_norm(q, None, cfg.rms_eps), rms_norm(k, None, cfg.rms_eps)
        v = v.reshape(B, T, Hkv, hdv)
        if cfg.gemma4_attn:  # gemma4's weightless V RMS norm (llama.py:853-855)
            v = rms_norm(v, None, cfg.rms_eps)
        if cfg.clamp_kqv:
            c = cfg.clamp_kqv
            q, k, v = (torch.clamp(t, -c, c) for t in (q, k, v))
        kv_q8 = k_view = v_view = None
        on_ring, bi = banks[li]
        if cache.quantized:  # llama.py:896-910
            kv_store(cache.k[bi], cache.v[bi], k, v, first, b0, cache.ks[bi], cache.vs[bi])
            kv_q8 = tuple(view(t[bi]) for t in (cache.k, cache.v, cache.ks, cache.vs))
        elif on_ring:  # the SWA layer's ring: stored with wrap, read whole
            kv_store(cache.kw[bi], cache.vw[bi], k, v, first, b0, ring=cache.ring)
            k_view = cache.kw[bi][b0: b0 + B].to(dtype)
            v_view = cache.vw[bi][b0: b0 + B].to(dtype)
        else:  # _store, llama.py:803-818
            kv_store(cache.k[bi], cache.v[bi], k, v, first, b0)
            k_view, v_view = view(cache.k[bi]).to(dtype), view(cache.v[bi]).to(dtype)
        att = attention(q, k_view, v_view, q_slots, kv_positions, positions, valid_from,
                        cfg, bool(windows[li]), kv_q8=kv_q8,
                        ring=cache.ring if on_ring else 0, sinks=lw.get("attn_sinks"))
        return att.reshape(B, T, H * hdv)

    def attend_shared(h, qw, li, lw, layer):
        """A shared-KV layer's attention (_attend_shared, llama.py:953-974)
        -> (B, T, H * hdv), before wo: Q alone, its per-head norm, RoPE at
        the layer's own base, attention at the layer's own window over the
        bank that bank_map names (an owning layer's, written earlier in this
        forward); no store. The view is this ubatch's rows and first L_view
        slots, as every layer reads its own bank (the JAX shared layer reads
        the bank whole: every row and slot, which fails where a server
        prefills one slot of several, and an int8 bank without its row
        scales; ROADMAP §3)."""
        q = qmm(h, qw["wq"], dtype, li).reshape(B, T, H, hd)
        if cfg.attn_qk_norm and "q_norm" in lw:
            q = rms_norm(q, lw["q_norm"], cfg.rms_eps)
        c, sn = (cos_swa, sin_swa) if rope_swa[layer] else (cos, sin)
        q = apply_rope(q, c, sn, cfg.rope_type, cfg.rope_dim)
        bi = banks[layer][1]
        kv_q8 = k_view = v_view = None
        if cache.quantized:
            kv_q8 = tuple(view(t[bi]) for t in (cache.k, cache.v, cache.ks, cache.vs))
        else:
            k_view, v_view = view(cache.k[bi]).to(dtype), view(cache.v[bi]).to(dtype)
        att = attention(q, k_view, v_view, q_slots, kv_positions, positions, valid_from, cfg,
                        bool(windows[layer]), kv_q8=kv_q8)
        return att.reshape(B, T, H * hdv)

    def attend_mla(h, qw, li, lw, layer):
        """An MLA layer's attention in the absorbed-MQA form (_attend_mla,
        llama.py:973-1041) -> (B, T, H * hdv), before wo: the q path (wq, or
        wq_a, its RMS norm and wq_b) split into nope and pe; wkv_a, then the
        latent c_kv's RMS norm and RoPE on q_pe and k_pe; q_nope absorbed
        into the latent space by wk_b in f32; the row [c_kv; k_pe] and c_kv
        stored as the one kv head's K and V (kv_store); attention over it at
        mla_scale; the per-head output lifted by wv_b in f32."""
        lora, rd = cfg.kv_lora_rank, cfg.rope_dim
        nope = hd - rd
        if "wq_a" in qw:
            ql = qmm(h, qw["wq_a"], dtype, li)[..., :cfg.q_lora_rank]
            q = qmm(rms_norm(ql, lw["q_a_norm"], cfg.rms_eps), qw["wq_b"], dtype, li)
        else:
            q = qmm(h, qw["wq"], dtype, li)
        q = q[..., :nq].reshape(B, T, H, hd)
        q_nope, q_pe = q[..., :nope], q[..., nope:]
        kvp = qmm(h, qw["wkv_a"], dtype, li)
        c_kv = rms_norm(kvp[..., :lora], lw["kv_a_norm"], cfg.rms_eps)
        k_pe = kvp[..., lora: lora + rd].reshape(B, T, 1, rd)
        q_pe = apply_rope(q_pe, cos, sin, cfg.rope_type, rd)
        k_pe = apply_rope(k_pe, cos, sin, cfg.rope_type, rd)
        q_abs = torch.einsum("bthn,hln->bthl", q_nope.to(torch.float32),
                             lw["wk_b"].to(torch.float32)).to(dtype)
        qq = torch.cat([q_abs, q_pe.to(dtype)], dim=-1)
        k_new = torch.cat([c_kv[:, :, None, :], k_pe.to(dtype)], dim=-1)
        v_new = c_kv[:, :, None, :]
        kv_q8 = k_view = v_view = None
        bi = banks[layer][1]
        if cache.quantized:
            kv_store(cache.k[bi], cache.v[bi], k_new, v_new, first, b0, cache.ks[bi],
                     cache.vs[bi])
            kv_q8 = tuple(view(t[bi]) for t in (cache.k, cache.v, cache.ks, cache.vs))
        else:
            kv_store(cache.k[bi], cache.v[bi], k_new, v_new, first, b0)
            k_view, v_view = view(cache.k[bi]).to(dtype), view(cache.v[bi]).to(dtype)
        att = attention(qq, k_view, v_view, q_slots, kv_positions, positions, valid_from,
                        cfg, kv_q8=kv_q8, scale=scale_mla)  # (B, T, H, lora)
        o = torch.einsum("bthl,hvl->bthv", att.to(torch.float32),
                         lw["wv_b"].to(torch.float32)).to(dtype)
        return o.reshape(B, T, H * hdv)

    def qkv_of(h, qw, li, lw):
        """The layer's q, k, v rows (llama.py:1200-1229): the load-time
        fused wqkv (padded offsets), the GGUF-fused wqkv_cat with its bias
        (unpadded offsets) or separate weights; then BitNet's per-tensor
        scales and the split biases (llama.py:1222-1229). lw: the layer's
        float tensors."""
        if "wqkv" in qw:
            y = qmm(h, qw["wqkv"], dtype, li)
            q, k, v = y[..., :nq], y[..., ok: ok + nk], y[..., ov: ov + nv]
        elif "wqkv_cat" in qw:
            y = qmm(h, qw["wqkv_cat"], dtype, li)
            if "bqkv_cat" in lw:
                y = y + lw["bqkv_cat"].to(dtype)
            q, k, v = y[..., :nq], y[..., nq: nq + nk], y[..., nq + nk: nq + nk + nv]
        else:
            q, k = qmm(h, qw["wq"], dtype, li), qmm(h, qw["wk"], dtype, li)
            # gemma4's layer without wv: V is the raw K projection, taken
            # before k_norm (llama.py:1212-1218)
            v = k if cfg.gemma4_attn and "wv" not in qw else qmm(h, qw["wv"], dtype, li)
        if "wq_s" in lw:
            q, k, v = (t * lw[s].to(dtype) for t, s in ((q, "wq_s"), (k, "wk_s"), (v, "wv_s")))
        if cfg.attn_bias and "bq" in lw:
            q, k, v = (t + lw[b].to(dtype) for t, b in ((q, "bq"), (k, "bk"), (v, "bv")))
        return q, k, v

    def pre_norm(x, lw, key):
        """The attention or FFN input: the residual stream, normed (with the
        norm's bias on layernorm archs) unless pre_norm is off (olmo2,
        exaone4: llama.py:1157-1158, 1293-1294)."""
        return _norm(x, lw.get(key), lw.get(key + "_b"), cfg) if cfg.pre_norm else x

    def post_norm(y, lw, key):
        """The attention or FFN output as the residual adds it: normed by
        glm4/exaone4/olmo2/gemma2/gemma3 (llama.py:1270-1271, 1319-1320),
        then times residual_scale (granite/minicpm, llama.py:1278-1279,
        1321-1322)."""
        if cfg.post_norms and key in lw:
            y = _norm(y, lw[key], None, cfg)
        if cfg.residual_scale != 1.0:
            y = (y.to(torch.float32) * cfg.residual_scale).to(dtype)
        return y

    def ffn_of(h2, qw, li, lw, layer, x, x0=None):
        """The layer's FFN: routed experts where it has them
        (llama.py:1273-1276), their router reading the residual stream x
        under moe_router_pre_norm (smallthinker), else the dense FFN. On the
        sequential block (``x0``, the layer's input, given) grok's and
        arctic's MoE layers run their dense FFN beside the experts
        (llama.py:1295-1314): grok's (dense + moe) x sqrt(2)/2 in f32 where
        the layer has a dense FFN, else the MoE alone; arctic's dense FFN
        plus the MoE on x0 under its own norm, ffn_norm_exps. ``layer``:
        the model's index of the layer (xIELU's parameters)."""
        if cfg.n_expert > 0 and "moe_gate_inp" in qw:
            def moe(inp, router_x=None):
                return moe_ffn(inp, qw, li, cfg, dtype, lw.get("moe_gate_inp_shexp"),
                               lw.get("moe_probs_b"),
                               {k: lw[k] for k in MOE_BIAS_KEYS if k in lw}, router_x)

            mode = cfg.moe_dense_parallel if x0 is not None else ""
            if mode == "grok":
                m = moe(h2)
                if "ffn_up" not in qw and "ffn_gateup" not in qw:
                    return m
                dense = ffn(h2, qw, li, cfg, dtype, lw, layer)
                return ((dense.to(torch.float32) + m.to(torch.float32))
                        * float(math.sqrt(2) / 2)).to(dtype)
            if mode == "arctic":
                return ffn(h2, qw, li, cfg, dtype, lw, layer) + moe(
                    _norm(x0, lw.get("ffn_norm_exps"), None, cfg))
            return moe(h2, x if cfg.moe_router_pre_norm else None)
        return ffn(h2, qw, li, cfg, dtype, lw, layer)

    for key in ("output_norm_b", "tok_norm_b"):
        if key in params and (cfg.norm_type != "layernorm" or (
                key == "tok_norm_b" and "tok_norm" not in params)):
            raise NotImplementedError(
                f"{key}: the config of arch {cfg.arch!r} ({cfg.norm_type}) reads no such bias")
    off = 0
    for gl in groups:
        extra = set(gl) - _LAYER_KEYS
        if extra:
            raise NotImplementedError(
                f"layer tensors {sorted(extra)}: not on the dense decoder or MoE path")
        unread = _unread_tensors(cfg, gl)
        if unread:
            raise NotImplementedError(
                f"layer tensors {unread}: the config of arch {cfg.arch!r} reads none of them")
        check_ffn_layout(cfg, gl)
        check_attn_gate(cfg, gl)
        mla = bool(cfg.kv_lora_rank)
        lack = sorted({"wkv_a", "kv_a_norm", "wk_b", "wv_b", "wo"} - set(gl)) if mla else []
        if mla and (lack or not {"wq", "wq_a"} & set(gl)):
            raise NotImplementedError(f"MLA layers without {lack or ['wq or wq_a']}")
        qw = {k: v for k, v in gl.items() if isinstance(v, QTensor)}
        fl = {k: v for k, v in gl.items() if k not in qw}  # norms, biases
        L_g = next(iter(gl.values())).shape[0]
        shared = check_shared_group(cfg, gl, off, L_g)
        use_block, use_fold = layer_routes(cfg, gl, qw, B, T, x.is_cuda, len(groups))
        if use_fold:
            # prime layer 0's norm + fused qkv; each layer kernel then emits
            # the next layer's qkv
            anrm = gl["attn_norm"]
            y = qmm(_norm(x, anrm[0], None, cfg), qw["wqkv"], dtype, 0)
            for li in range(L_g):
                lw = {k: v[li] for k, v in fl.items()}
                yd = y.to(dtype)
                att = attend(yd[..., :nq], yd[..., ok: ok + nk], yd[..., ov: ov + nv],
                             off + li, lw)
                x, y = ffn_block_qkv(att, x, lw["ffn_norm"], anrm, qw, li, cfg)
                x = x.to(dtype)
        else:
            for li in range(L_g):
                lw = {k: v[li] for k, v in fl.items()}
                layer = off + li

                def attend_of(h):  # the attention's output before wo
                    if shared:
                        return attend_shared(h, qw, li, lw, layer)
                    return attend(*qkv_of(h, qw, li, lw), layer, lw)

                if cfg.altup_n:  # llama.py:1071-1147
                    x = altup_layer(x, qw, li, lw, layer, pli[:, :, layer],
                                    lambda h: qmm(attend_of(h), qw["wo"], dtype, li), cfg, dtype)
                    continue
                x0 = x
                h = pre_norm(x, lw, "attn_norm")
                if mla:  # llama.py:1159-1174
                    x = x + qmm(attend_mla(h, qw, li, lw, layer), qw["wo"], dtype, li)
                    x = x + ffn_of(pre_norm(x, lw, "ffn_norm"), qw, li, lw, layer, x)
                    continue
                att = attend_of(h)
                if "wqkv_gate" in qw:  # llama.py:1231-1245
                    gate = torch.sigmoid(qmm(h, qw["wqkv_gate"], dtype, li).to(torch.float32))
                    if gate.shape[-1] == H:  # step35: one sigmoid a head
                        gate = gate[..., None].expand(B, T, H, hdv).reshape(B, T, H * hdv)
                    # afmoe's: one a column of the attention output
                    att = (att.to(torch.float32) * gate).to(dtype)
                if use_block:
                    x = ffn_block(att, x, lw["ffn_norm"], qw, li, cfg).to(dtype)
                    continue
                if cfg.sub_norms and "attn_sub_norm" in lw:  # bitnet (llama.py:1256-1260)
                    att = rms_norm(att, lw["attn_sub_norm"], cfg.rms_eps)
                a = qmm(att, qw["wo"], dtype, li)
                if "wo_s" in lw:  # llama.py:1262-1263
                    a = a * lw["wo_s"].to(dtype)
                if "bo" in lw:  # llama.py:1264-1265
                    a = a + lw["bo"].to(dtype)
                if cfg.attn_out_scale:  # mimo2's value scale (llama.py:1268-1269)
                    a = (a.to(torch.float32) * cfg.attn_out_scale).to(dtype)
                a = post_norm(a, lw, "post_attn_norm")
                if cfg.parallel_residual:  # llama.py:1280-1290
                    if "attn_norm_2" in lw:  # falcon-40B
                        h2 = _norm(x, lw["attn_norm_2"], lw.get("attn_norm_2_b"), cfg)
                    elif "ffn_norm" in lw:  # gptneox
                        h2 = _norm(x, lw["ffn_norm"], lw.get("ffn_norm_b"), cfg)
                    else:  # phi2, command-r, falcon-7B, gptj, plamo: the attention's input
                        h2 = h
                    x = x + a + ffn_of(h2, qw, li, lw, layer, x)
                else:
                    x = x + a
                    h2 = pre_norm(x, lw, "ffn_norm")
                    x = x + post_norm(ffn_of(h2, qw, li, lw, layer, x, x0), lw, "post_ffn_norm")
                if "per_layer_inp_gate" in qw:  # gemma4 (llama.py:1042-1053, 1324)
                    x = x + per_layer_block(x, pli[:, :, layer], qw, li, lw, cfg,
                                            dtype).to(dtype)
                if "out_scale" in lw:  # gemma4's per-layer output scale (llama.py:1325-1327)
                    x = (x.to(torch.float32) * lw["out_scale"].to(torch.float32)).to(dtype)
        off += L_g
    if logits_idx is not None:  # llama.py:1527-1530
        x = x[:, logits_idx: logits_idx + 1]
    if cfg.altup_n:  # the streams' merge (llama.py:1531-1541)
        x = altup_merge(x, params["altup_unembd_proj"], cfg, dtype)
    x = _norm(x, params.get("output_norm"), params.get("output_norm_b"), cfg)
    logits = qmm(x, params["output"], dtype).to(torch.float32)
    if cfg.logit_scale != 1.0:  # llama.py:1546-1547: a product, as in the JAX package
        logits = logits * cfg.logit_scale
    if cfg.final_logit_softcap:  # llama.py:1548-1549
        logits = torch.tanh(logits / cfg.final_logit_softcap) * cfg.final_logit_softcap
    return logits, cache
