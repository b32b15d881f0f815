"""Architecture registry of the PyTorch port: per-arch defaults.

Counterpart of tpullm/models/registry.py, holding only the archs the port
runs. Rows are DEFAULTS: a value the GGUF set explicitly wins.
"""
from __future__ import annotations

ARCH_REGISTRY: dict[str, dict] = {
    # rope_type: "norm" = interleaved pairs (ggml GGML_ROPE_TYPE_NORM),
    # "neox" = half-split. Matches llama_model_rope_type() per arch.
    "llama": dict(rope_type="norm"),
    "mistral": dict(rope_type="norm"),
    # mistral3 (src/models/mistral3.cpp): llama graph + optional attention
    # temperature scaling
    "mistral3": dict(rope_type="norm"),
    "qwen2": dict(rope_type="neox", attn_bias=True),
    "qwen3": dict(rope_type="neox", attn_qk_norm=True),
    "qwen3moe": dict(rope_type="neox", attn_qk_norm=True,
                     expert_weights_norm=True),
    "qwen2moe": dict(rope_type="neox", attn_bias=True),
    "gemma": dict(rope_type="neox", act_fn="gelu", embedding_scale=-1.0),
    "gemma2": dict(rope_type="neox", act_fn="gelu", post_norms=True,
                   embedding_scale=-1.0, swa_pattern=2,
                   # reference defaults when the GGUF lacks the keys
                   # (src/models/gemma2.cpp: ml.get_key(..., false) over
                   # hparams.h defaults 50/30)
                   attn_logit_softcap=50.0, final_logit_softcap=30.0),
    "gemma3": dict(rope_type="neox", act_fn="gelu", post_norms=True, attn_qk_norm=True, embedding_scale=-1.0, swa_pattern=6),
    # mixtral (llama MoE branch, src/models/llama.cpp:208): top-k
    # router weights are RENORMALIZED (build_moe_ffn norm_w=true). The
    # "llama" row has no such default, as in the JAX registry, so a llama
    # GGUF with experts is computed without renormalization there and here.
    "mixtral": dict(rope_type="norm", expert_weights_norm=True),
    # olmo2 (src/models/olmo2.cpp:45): FLAT q/k RMS norms over the
    # full row ({n_embd} / {n_kv*head_dim}), applied before rope
    "olmo2": dict(rope_type="neox", post_norms=True, pre_norm=False,
                  attn_qk_norm_flat=True),
    "internlm2": dict(rope_type="norm"),
    "exaone": dict(rope_type="norm"),
    # exaone4 (src/models/exaone4.cpp): post-norm ONLY like olmo2
    "exaone4": dict(rope_type="neox", post_norms=True, pre_norm=False,
                    attn_qk_norm=True),
    # glm4 (src/models/glm4.cpp): partial rope; gemma2-style post norms
    "glm4": dict(rope_type="norm", post_norms=True),
    "granite": dict(rope_type="norm"),
    "minicpm": dict(rope_type="norm"),
    "granitemoe": dict(rope_type="norm"),
    "baichuan": dict(rope_type="norm"),
    "xverse": dict(rope_type="norm"),
    "qwen": dict(rope_type="neox", attn_bias=True),
    # llama-shaped singles (src/models/{ernie4-5,seed-oss,...}.cpp)
    "ernie4_5": dict(rope_type="norm"),
    "seed_oss": dict(rope_type="neox"),
    "hunyuan-dense": dict(rope_type="neox", attn_qk_norm=True),
    # maincoder (src/models/maincoder.cpp): per-head qk norm AFTER rope
    "maincoder": dict(rope_type="norm", attn_qk_norm=True,
                      qk_norm_post_rope=True),
    # layernorm, bias and parallel-residual decoders
    "phi2": dict(rope_type="neox", parallel_residual=True, norm_type="layernorm", act_fn="gelu", ffn_gate=False, attn_bias=True),
    "starcoder2": dict(rope_type="neox", norm_type="layernorm", act_fn="gelu", ffn_gate=False, attn_bias=True),
    "gptneox": dict(rope_type="neox", norm_type="layernorm", act_fn="gelu", ffn_gate=False, parallel_residual=True, attn_bias=True),
    "stablelm": dict(rope_type="neox", norm_type="layernorm"),
    "cohere2": dict(rope_type="norm", norm_type="layernorm", swa_pattern=4),
    "command-r": dict(rope_type="norm", norm_type="layernorm", parallel_residual=True),
    "codeshell": dict(rope_type="neox", norm_type="layernorm", act_fn="gelu",
                      ffn_gate=False, attn_bias=True),
    # ---- legacy GPT family (layernorm + biases, learned/ALiBi positions,
    # src/models/{gpt2,starcoder,bloom,mpt,jais,codeshell}.cpp) ----
    "gpt2": dict(norm_type="layernorm", act_fn="gelu", ffn_gate=False,
                 attn_bias=True, use_rope=False),
    "starcoder": dict(norm_type="layernorm", act_fn="gelu", ffn_gate=False,
                      attn_bias=True, use_rope=False),
    "bloom": dict(norm_type="layernorm", act_fn="gelu", ffn_gate=False,
                  attn_bias=True, use_rope=False),
    "mpt": dict(norm_type="layernorm", act_fn="gelu", ffn_gate=False,
                use_rope=False, attn_qk_norm_flat=True),
    "jais": dict(norm_type="layernorm", act_fn="silu", attn_bias=True,
                 use_rope=False),
    # refact (src/models/refact.cpp): ALiBi hardcoded to 8.0 (no GGUF KV),
    # which also disables rope (llama_model_rope_type -> NONE)
    "refact": dict(alibi_max_bias=8.0),
    # falcon (src/models/falcon.cpp): parallel attention+FFN off the attn
    # norm (7B) or a second norm (40B, attn_norm_2)
    "falcon": dict(rope_type="neox", norm_type="layernorm", act_fn="gelu",
                   ffn_gate=False, parallel_residual=True),
    # olmo-1 (src/models/olmo.cpp): weightless layernorm, optional clamp
    "olmo": dict(rope_type="norm", norm_type="layernorm"),
    "nemotron": dict(rope_type="neox", norm_type="layernorm", act_fn="relu2",
                     ffn_gate=False, attn_bias=True),
    "orion": dict(rope_type="neox", norm_type="layernorm"),
    "plamo": dict(rope_type="neox", parallel_residual=True),
    # gptj: enum-only in the reference (no loader/graph there,
    # src/llama-arch.cpp:17 with no llama_model_gptj) — covered here by
    # the flag table: parallel residual, gelu MLP, first-rot-dims rope
    "gptj": dict(rope_type="norm", parallel_residual=True, act_fn="gelu",
                 ffn_gate=False),
    "arcee": dict(rope_type="norm", act_fn="relu2", ffn_gate=False),
    # jais2 (src/models/jais2.cpp): layernorm + relu2 no-gate MLP, biases on
    # attention and FFN projections
    "jais2": dict(rope_type="neox", norm_type="layernorm", act_fn="relu2",
                  ffn_gate=False, attn_bias=True),
    # ---- rows whose files run on the paths above as they are ----
    # llama-embed (src/models/models.h llama_model_llama_embed): the llama
    # graph in embedding mode — same weights/dataflow, pooled output (its
    # pooling key still raises: no pooled output in the port)
    "llama-embed": dict(rope_type="norm"),
    # qwen2vl (src/models/qwen2vl.cpp): the qwen2 graph with M-RoPE
    # (ggml_rope_multi + rope.dimension_sections). For TEXT tokens all
    # position channels are equal, under which the M-RoPE sector walk
    # (ggml-cpu/ops.cpp ggml_mrope_cache_init) reduces EXACTLY to neox
    # rope; image-grid positions route through the mtmd path (the sections
    # key still raises in the port)
    "qwen2vl": dict(rope_type="neox", attn_bias=True),
    # qwen3vl/qwen3vlmoe (src/models/qwen3vl.cpp): the qwen3 graph with
    # interleaved M-RoPE (ggml_rope_multi IMROPE); text positions reduce to
    # neox rope as above
    "qwen3vl": dict(rope_type="neox", attn_qk_norm=True),
    "qwen3vlmoe": dict(rope_type="neox", attn_qk_norm=True,
                       expert_weights_norm=True),
    "smollm3": dict(rope_type="norm"),
    # hunyuan_vl (src/models/hunyuan-vl.cpp): qwen2vl-shaped with
    # POST-rope per-head qk RMS norms and XDRoPE alpha freq-base scaling
    "hunyuan_vl": dict(rope_type="neox", attn_qk_norm=True,
                       qk_norm_post_rope=True),
    # paddleocr (src/models/paddleocr.cpp): "same with qwen2vl.cpp, but
    # bias tensors are optional" — M-RoPE text reduction applies
    "paddleocr": dict(rope_type="neox", attn_bias=True),
    # pangu-embedded (src/models/pangu-embed.cpp): llama-shape, wo bias
    "pangu-embedded": dict(rope_type="neox"),
    # kimi-linear (src/models/kimi-linear.cpp): KDA (per-key-channel-decay
    # delta attention w/ separate q/k/v convs + sigmoid-gated output norm)
    # on kv==0 layers, ROPELESS absorbed-MQA MLA on the rest, renormalized
    # MoE + gated shared expert after a dense lead (the KDA and MLA layers'
    # tensors and keys still raise in the port)
    "kimi-linear": dict(),
    # ---- MoE family batch (src/models/{deepseek,olmoe,phimoe,hunyuan-moe,
    # ernie4-5-moe,glm4-moe,exaone-moe,dots1,bailingmoe}.cpp) ----
    "deepseek": dict(rope_type="norm"),
    "olmoe": dict(rope_type="neox", attn_qk_norm_flat=True),
    "phimoe": dict(rope_type="neox", norm_type="layernorm"),
    "hunyuan-moe": dict(rope_type="neox", attn_qk_norm=True),
    # leading dense layers and the router's selection bias (exp_probs_b)
    "ernie4_5-moe": dict(rope_type="norm"),
    "glm4moe": dict(rope_type="neox", attn_qk_norm=True),
    # deepseek2-ocr (src/models/deepseek2ocr.cpp + deepseek2.cpp is_ocr
    # branch): PLAIN MHA (no MLA) with full-head neox rope hardcoded in
    # the graph, deepseek-style gated MoE + shared experts after a dense
    # lead
    "deepseek2-ocr": dict(rope_type="neox"),
    "exaone-moe": dict(rope_type="neox", attn_qk_norm=True),
    "dots1": dict(rope_type="neox", attn_qk_norm=True),
    "bailingmoe": dict(rope_type="norm"),
    # bailingmoe2 (src/models/bailingmoe2.cpp): fused wqkv, per-head
    # qk-norm, leading dense layers, router probs bias + shared experts,
    # gating func from GGUF (sigmoid in shipped checkpoints)
    "bailingmoe2": dict(rope_type="neox", attn_qk_norm=True),
    # minimax-m2 (src/models/minimax-m2.cpp): flat (full-row) qk RMS before
    # rope, every layer MoE with router probs bias
    "minimax-m2": dict(rope_type="neox", attn_qk_norm_flat=True),
    # ---- MLA, the compressed-KV attention (src/models/deepseek2.cpp) ----
    "deepseek2": dict(rope_type="neox"),
    # minicpm3 (src/models/minicpm3.cpp): MLA attention like deepseek2
    "minicpm3": dict(rope_type="neox"),
    # mistral4 subclasses deepseek2 (MLA attention, src/models/models.h
    # llama_model_mistral4)
    "mistral4": dict(rope_type="neox"),
    # plm (src/models/plm.cpp): MLA attention (direct wq + legacy wkv_b)
    # with a relu^2 ungated MLP
    "plm": dict(rope_type="norm", act_fn="relu2", ffn_gate=False),
    # glm-dsa (src/models/glm-dsa.cpp): deepseek2's MLA graph verbatim
    # (models.h:1013 `using graph = llama_model_deepseek2::graph`) +
    # sigmoid-gated MoE w/ probs bias; the DSA indexer tensors are loaded
    # but UNUSED by the reference graph (sparse top-k not implemented
    # there) — mirrored here by ignoring them at load
    "glm-dsa": dict(rope_type="neox", expert_gating="sigmoid"),
    # ---- the combined [gate; up] in one ffn_up, the per-layer SWA array ----
    # phi3 (src/models/phi3.cpp): fused attn_qkv, the combined ffn_up
    "phi3": dict(rope_type="neox"),
    # chatglm/glm4 (src/models/{chatglm,glm4}.cpp): partial rope; glm4 adds
    # gemma2-style post norms
    "chatglm": dict(rope_type="norm", attn_bias=True),
    # PLaMo-3 (src/models/plamo3.cpp): dense transformer, fused QKV +
    # shared per-head-dim q/k norms (pre-rope), sandwich post-norms, fused
    # swiglu ffn_up, optional SWA pattern
    "plamo3": dict(rope_type="neox", post_norms=True, attn_qk_norm=True),
    # step35 (src/models/step35.cpp): qk norms, per-layer SWA array,
    # per-HEAD sigmoid attention gate (g_proj -> (n_head,)), MoE + shexp
    "step35": dict(rope_type="neox", attn_qk_norm=True,
                   attn_gate_proj=True),
    # ---- attention sinks, the clamped SwiGLU and the attention value scale ----
    "gpt-oss": dict(rope_type="neox", act_fn="swiglu_oai", attn_bias=True),
    # mimo2 (src/models/mimo2.cpp): per-layer SWA array + swa rope base,
    # optional per-layer attention sinks, attention-output value scale,
    # sigmoid MoE with probs bias, nextn trim
    "mimo2": dict(rope_type="neox", expert_gating="sigmoid"),
    # ---- the iRoPE decoders: NoPE layers on a period, chunked windows ----
    # llama4 (src/models/llama4.cpp): 3-chunked-1-full attention pattern,
    # iRoPE (every 4th layer NoPE + floor-scaled attn temperature), QK
    # L2-norm on rope layers, sigmoid-gated MoE
    "llama4": dict(rope_type="norm", swa_pattern=4, swa_chunked=True,
                   no_rope_interval=4, attn_temp_scale=0.1,
                   qk_l2_norm=True, expert_gating="sigmoid"),
    # smallthinker (src/models/smallthinker.cpp): every-layer relu MoE with
    # the ROUTER reading the raw layer input (pre-norm), renormalized top-k,
    # dense-first SWA pattern whose dense layers skip rope
    "smallthinker": dict(rope_type="neox", act_fn="relu",
                         expert_weights_norm=True, moe_router_pre_norm=True,
                         swa_dense_first=True, no_rope_offset=0),
    # afmoe (src/models/afmoe.cpp): gemma-scaled embeddings, iSWA 3:1 with
    # iRoPE-style no-rope on every 4th layer, per-head qk-norm, attention
    # output gate (sigmoid of a separate projection of the attn input),
    # dual pre/post norms, sigmoid MoE with probs bias + shared expert
    "afmoe": dict(rope_type="neox", attn_qk_norm=True, post_norms=True,
                  attn_gate_proj=True, embedding_scale=-1.0,
                  no_rope_interval=4, swa_pattern=4,
                  expert_gating="sigmoid"),
    # the other MoE families
    "dbrx": dict(rope_type="neox", norm_type="layernorm",
                 expert_weights_norm=True),
    # grok-1 (src/models/grok.cpp): attention logits softcapped at 30 with
    # the scale applied INSIDE the tanh (build_attn LLM_ARCH_GROK branch,
    # llama-graph.cpp:2009-2020), post-attn/ffn norms, scaled embeddings +
    # logits, GELU MoE with renormalized router, optional dense FFN summed
    # with the MoE output at sqrt(2)/2. (The router_logit_softcapping hparam
    # is loaded by the reference but never applied in its graph.)
    "grok": dict(rope_type="neox", act_fn="gelu", post_norms=True,
                 expert_weights_norm=True, attn_logit_softcap=30.0,
                 attn_scale=0.08838834764831845,
                 embedding_scale=78.38367176906169,
                 logit_scale=0.5773502691896257,
                 moe_dense_parallel="grok"),
    # arctic (src/models/arctic.cpp): dense n_embd-wide residual MLP plus a
    # parallel MoE read from its own norm of the LAYER INPUT (ffn_norm_exps)
    "arctic": dict(rope_type="norm", expert_weights_norm=True,
                   moe_dense_parallel="arctic"),
    # grovemoe (src/models/grovemoe.cpp): qwen3-style attention; MoE plus
    # adjugate "chunk" experts indexed main_id // experts_per_group, scaled
    # by expert_group_scale, sharing the main router's sigmoid probs
    "grovemoe": dict(rope_type="neox", attn_qk_norm=True,
                     expert_weights_norm=True),
    # gemma4 (src/models/gemma4.cpp): per-layer token-embedding stream
    # (gated into each layer's output), trailing layers share the last KV
    # layers' caches, optional wv (v = k), WEIGHTLESS V rms-norm, NO
    # attention scaling (f_attention_scale = 1.0), gelu FFN, sandwich
    # norms, per-layer out_scale, final logit softcap
    "gemma4": dict(rope_type="neox", act_fn="gelu", post_norms=True,
                   attn_qk_norm=True, attn_scale=1.0, gemma4_attn=True,
                   embedding_scale=-1.0),
    # gemma3n (src/models/gemma3n.cpp): AltUp 4-stream residual stack +
    # laurel low-rank bypass + per-layer token-embedding stream +
    # activation sparsity on the first 10 layers + trailing shared-KV
    # layers (>=20); weightless V norm, no attention scaling, swa period 5
    "gemma3n": dict(rope_type="neox", act_fn="gelu", post_norms=True,
                    attn_qk_norm=True, attn_scale=1.0, gemma4_attn=True,
                    embedding_scale=-1.0, swa_pattern=5, altup_n=4,
                    n_layer_sparsity=10, final_logit_softcap=30.0),
    # cogvlm (src/models/cogvlm.cpp): fused-QKV llama block with a
    # parallel VISION-EXPERT weight set (visexp_*) selected per token
    # kind; text serving uses the language weights
    "cogvlm": dict(rope_type="neox"),
    # bitnet b1.58 (src/models/bitnet.cpp): RMS sub-norms inside the
    # attention/FFN blocks, per-tensor output scales, tied lm_head
    "bitnet": dict(rope_type="neox", sub_norms=True),
    # chameleon (src/models/chameleon.cpp): per-head LAYERNORM q/k-norm
    # (with bias) before rope; swin_norm variant not fabricated
    "chameleon": dict(rope_type="norm", attn_qk_norm=True,
                      qk_norm_type="layernorm"),
    # apertus (src/models/apertus.cpp): qk RMS norm + ungated xIELU MLP
    "apertus": dict(rope_type="neox", attn_qk_norm=True, ffn_gate=False,
                    act_fn="xielu"),
}


def get_arch(name: str) -> dict:
    return ARCH_REGISTRY.get(name, {})


def apply_arch_defaults(cfg) -> None:
    import dataclasses

    field_defaults = {f.name: f.default for f in dataclasses.fields(type(cfg))}
    for k, v in get_arch(cfg.arch).items():
        if k in field_defaults and getattr(cfg, k) != field_defaults[k]:
            continue  # GGUF-provided value takes precedence
        if k == "embedding_scale" and v == -1.0:
            cfg.embedding_scale = float(cfg.n_embd) ** 0.5
        else:
            setattr(cfg, k, v)
