"""GGUF checkpoint -> params on the device (dense llama and MoE paths).

Counterpart of tpullm/runtime/loader.py:291-450: reads each tensor from the
mmap, repacks quantized weights into the K-major kernel layout (planar
where the kernels do not take them), stacks per-layer tensors along a
leading layer axis (split into groups where the per-layer quant types or
tensor sets change: a dense lead ahead of MoE layers is a group of its
own), fuses QKV and gate/up, then places everything on ``device``. The
NextN layers that config_from_gguf takes off n_layer (glm4moe) are not
read.
Expert weights (E, n, k) are repacked per expert and stacked to
(L, E, Npad, K); the expert gate/up stay unfused, as in the JAX package,
and so do the shared expert's (qwen2moe), whose sigmoid gate vector loads
as f32 (loader.py:103-107, 362), as do the router's selection bias
``moe_probs_b`` (loader.py:108, 355), gpt-oss's router bias
``moe_gate_inp_b`` and expert biases ``moe_{gate,up,down}_exps_b``
(loader.py:109-112) and the attention sinks ``attn_sinks`` (loader.py:49,
362). A key that only some layers carry (mimo2's sinks) splits the depth
into layer groups, as the JAX loader stacks it. The dense decoder's flag tensors load
as the JAX package names them: q/k biases and norms, the GGUF-fused attn_qkv
with its bias, the post-norms, the layernorm archs' norm biases (the
output norm's too), falcon-40B's attn_norm_2, the output projection's bias
and the dense FFN's gate, up and down biases (loader.py:25, 35, 64, 189-215),
mpt's flat q/k norm biases (loader.py:37-38), the learned position table
and bloom's embedding layernorm (loader.py:218-221, all f32); glm4moe's
post_attention_norm becomes its ffn_norm (loader.py:410-414), plamo3's
bare post-norm names and afmoe's attn_post_norm/ffn_post_norm load as the
post-norms, and the attention output gate (step35's per head, afmoe's as
wide as the attention output) as wqkv_gate (loader.py:86-89, 137). A GGUF-combined
[gate; up] (phi3, chatglm, plamo3) stays ffn_up, or becomes ffn_gateup
where it is the fused layout already (ops/fuse.py). An MLA
config (kv_lora_rank) also reads its attention's tensors (loader.py:41-48):
wq or wq_a/q_a_norm/wq_b, wkv_a and kv_a_norm, and the absorption banks
wk_b and wv_b as dense f32, split from a legacy attn_kv_b where the file
has one (_mla_prepare, loader.py:268-290); glm-dsa's DSA indexer tensors
and dbrx's FFN norm bias are passed over unread, as the JAX loader
leaves them. grovemoe's
chunk-expert bank (n_group_experts), arctic's ffn_norm_exps, and the
attn_output_norm of grok (its post-attention norm) and dbrx (its FFN norm,
load for those configs alone (loader.py:95-99, 401-409);
a layer of grok or arctic loads its dense FFN beside the experts.
gemma4's and gemma3n's per-layer input block (inp_gate, proj and post_norm;
the first two as weights, the norm f32) and gemma4's layer_output_scale
load for those configs, and so do the per-layer token stream's tables
(loader.py:71-74, 207-212); gemma3n's AltUp and LAuReL tensors load as f32
(loader.py:76-83, 355-358), as do its AltUp stream projections, and the
dead K/V projections of its shared-KV layers are dropped (loader.py:334-348).
bitnet's sub-norms (attn_sub_norm, ffn_sub_norm) and the per-tensor scales
of its seven projections (wq_s, wk_s, wv_s, wo_s, ffn_gate_s, ffn_up_s,
ffn_down_s) load as f32 for configs with sub_norms (loader.py:50-59: the
JAX loader reads the names for any arch), and so do chameleon's per-head
(H, hd) q/k norms and their biases. cogvlm's vision-expert weights (vis_*)
are passed over unread: the text path reads none of them, as the JAX loader
leaves them, so they stay in the file and never reach the device.
Every other tensor (the output bias that phi-2's file carries, grok's
layer_output_norm, ...) raises, and so does a shared
expert without all of its gate, up and down.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..gguf.reader import GGUFFile
from ..models.config import config_from_gguf
from ..models.llama import SHEXP_KEYS
from ..ops._cuda import resolve_device
from ..ops.fuse import fuse_layer_weights
from ..ops.qtensor import _FLOAT_TYPES, QTensor, qtensor_from_bytes
from ..quant.numpy_impl import dequantize

# GGUF tensor-name suffix -> params key, for the tensors of a dense llama
LAYER_TENSORS = {
    "attn_norm.weight": "attn_norm",
    "attn_norm.bias": "attn_norm_b",
    "attn_norm_2.weight": "attn_norm_2",  # falcon-40B's parallel FFN norm
    "attn_norm_2.bias": "attn_norm_2_b",
    "attn_q.weight": "wq",
    "attn_k.weight": "wk",
    "attn_v.weight": "wv",
    "attn_qkv.weight": "wqkv_cat",  # GGUF-fused [q;k;v] (qwen)
    "attn_qkv.bias": "bqkv_cat",
    "attn_output.weight": "wo",
    "attn_output.bias": "bo",
    "attn_q.bias": "bq",
    "attn_k.bias": "bk",
    "attn_v.bias": "bv",
    "attn_q_norm.weight": "q_norm",
    "attn_k_norm.weight": "k_norm",
    "attn_q_norm.bias": "q_norm_b",  # mpt's flat layernorm q/k norms
    "attn_k_norm.bias": "k_norm_b",
    "ffn_norm.weight": "ffn_norm",
    "ffn_norm.bias": "ffn_norm_b",
    "ffn_gate.weight": "ffn_gate",
    "ffn_gate.bias": "ffn_gate_b",  # jais
    "ffn_up.weight": "ffn_up",
    "ffn_up.bias": "ffn_up_b",
    "ffn_down.weight": "ffn_down",
    "ffn_down.bias": "ffn_down_b",
    "post_attention_norm.weight": "post_attn_norm",
    "post_ffw_norm.weight": "post_ffn_norm",
    # plamo3 writes its sandwich norms without the .weight suffix (loader.py:86-87)
    "post_attention_norm": "post_attn_norm",
    "post_ffw_norm": "post_ffn_norm",
    # afmoe's names of the post-norms (loader.py:88-89)
    "attn_post_norm.weight": "post_attn_norm",
    "ffn_post_norm.weight": "post_ffn_norm",
    # the attention output gate (loader.py:137): step35's per head, afmoe's
    # as wide as the attention output
    "attn_gate.weight": "wqkv_gate",
    # routed experts (loader.py:91-94); the router is F32 in real GGUFs and
    # takes the dense layout
    "ffn_gate_inp.weight": "moe_gate_inp",
    "ffn_gate_exps.weight": "moe_gate_exps",
    "ffn_up_exps.weight": "moe_up_exps",
    "ffn_down_exps.weight": "moe_down_exps",
    # the shared expert and its per-token sigmoid gate (loader.py:103-107)
    "ffn_gate_shexp.weight": "ffn_gate_shexp",
    "ffn_up_shexp.weight": "ffn_up_shexp",
    "ffn_down_shexp.weight": "ffn_down_shexp",
    "ffn_gate_inp_shexp.weight": "moe_gate_inp_shexp",
    # the router's selection bias (loader.py:108), added to the
    # probabilities for the top-k choice only
    "exp_probs_b.bias": "moe_probs_b",
    # gpt-oss: the router's bias on its logits and each expert's gate, up
    # and down biases (loader.py:109-112), and the per-head attention sink
    # logits (loader.py:49), on every layer or on some (mimo2)
    "ffn_gate_inp.bias": "moe_gate_inp_b",
    "ffn_gate_exps.bias": "moe_gate_exps_b",
    "ffn_up_exps.bias": "moe_up_exps_b",
    "ffn_down_exps.bias": "moe_down_exps_b",
    "attn_sinks.weight": "attn_sinks",
}
# MLA's tensors (loader.py:41-48), read where the config has kv_lora_rank:
# elsewhere they are unknown names and raise. The split attn_k_b/attn_v_b,
# or the legacy attn_kv_b that _mla_prepare splits
MLA_TENSORS = {
    "attn_q_a.weight": "wq_a",
    "attn_q_b.weight": "wq_b",
    "attn_q_a_norm.weight": "q_a_norm",
    "attn_kv_a_mqa.weight": "wkv_a",
    "attn_kv_a_norm.weight": "kv_a_norm",
    "attn_k_b.weight": "wk_b",
    "attn_v_b.weight": "wv_b",
    "attn_kv_b.weight": "wkv_b",
}
# grovemoe's chunk-expert bank (loader.py:96-99), read where the config has
# n_group_experts; arctic's norm of the MoE's input (loader.py:95), read for
# arctic's block; grok's post-attention norm and dbrx's FFN norm, both
# shipped as attn_output_norm (loader.py:401-409), read for those two archs.
# Elsewhere they are unknown names and raise
CHEXP_TENSORS = {
    "ffn_gate_chexps.weight": "moe_gate_chexps",
    "ffn_up_chexps.weight": "moe_up_chexps",
    "ffn_down_chexps.weight": "moe_down_chexps",
}
ARCTIC_TENSORS = {"ffn_norm_exps.weight": "ffn_norm_exps"}
# bitnet's sub-norms and per-tensor output scales (loader.py:50-59), read
# where the config has sub_norms (bitnet's row); elsewhere they are unknown
# names and raise
BITNET_TENSORS = {
    "attn_sub_norm.weight": "attn_sub_norm",
    "ffn_sub_norm.weight": "ffn_sub_norm",
    "attn_q.scale": "wq_s",
    "attn_k.scale": "wk_s",
    "attn_v.scale": "wv_s",
    "attn_output.scale": "wo_s",
    "ffn_gate.scale": "ffn_gate_s",
    "ffn_up.scale": "ffn_up_s",
    "ffn_down.scale": "ffn_down_s",
}
# gemma4's and gemma3n's per-layer input block and gemma4's layer output
# scale (loader.py:71-74), read where the config has the per-layer token
# stream or gemma4's attention; gemma3n's AltUp and LAuReL tensors
# (loader.py:76-83), read where it has altup_n. Elsewhere they are unknown
# names and raise
PLE_TENSORS = {
    "inp_gate.weight": "per_layer_inp_gate",
    "proj.weight": "per_layer_proj",
    "post_norm.weight": "per_layer_post_norm",
    "layer_output_scale.weight": "out_scale",
}
ALTUP_TENSORS = {
    "altup_correct_coef.weight": "altup_correct_coef",
    "altup_correct_scale.weight": "altup_correct_scale",
    "altup_predict_coef.weight": "altup_predict_coef",
    "altup_router.weight": "altup_router",
    "altup_router_norm.weight": "altup_router_norm",
    "laurel_l.weight": "laurel_l",
    "laurel_r.weight": "laurel_r",
    "laurel_post_norm.weight": "laurel_post_norm",
}
# gemma3n's shared-KV layers ship K/V projections its graph never runs
# (loader.py:334-348): they are dropped, so those layers form their own group
SHARED_KV_DEAD = frozenset({"wk", "wv", "k_norm", "bk", "bv"})
OUT_NORM_TENSORS = {"grok": {"attn_output_norm.weight": "post_attn_norm"},
                    "dbrx": {"attn_output_norm.weight": "ffn_norm"}}
# the only names the loader passes over unread, each for its arch alone:
# glm-dsa's DSA indexer, which its reference graph loads and does not run
# (src/models/glm-dsa.cpp; the JAX loader reads none of it), the bias
# of dbrx's FFN norm, which its graph does not read (src/models/dbrx.cpp;
# the JAX loader drops it, loader.py:405-409), and cogvlm's vision-expert
# weights, which only image tokens read (src/models/cogvlm.cpp; the JAX
# loader's name map has none of them): the text path leaves them in the file
UNREAD_TENSORS = {"glm-dsa": ("indexer.k_norm.weight", "indexer.k_norm.bias",
                              "indexer.proj.weight", "indexer.attn_k.weight",
                              "indexer.attn_q_b.weight"),
                  "dbrx": ("attn_output_norm.bias",),
                  "cogvlm": ("vis_attn_qkv.weight", "vis_attn_output.weight", "vis_gate.weight",
                             "vis_up.weight", "vis_down.weight")}
# norms, biases, the shared expert's gate, the selection bias, the router's
# and the experts' biases, the sinks and bitnet's scales load as f32 arrays
# (loader.py:209-229, 355-362)
_FLOAT_LAYER_KEYS = {"attn_norm", "ffn_norm", "q_norm", "k_norm", "post_attn_norm",
                     "post_ffn_norm", "bq", "bk", "bv", "bqkv_cat", "moe_gate_inp_shexp",
                     "moe_probs_b", "moe_gate_inp_b", "moe_gate_exps_b", "moe_up_exps_b",
                     "moe_down_exps_b", "attn_sinks",
                     "attn_norm_b", "ffn_norm_b", "attn_norm_2", "attn_norm_2_b", "bo",
                     "ffn_up_b", "ffn_down_b", "ffn_gate_b", "q_norm_b", "k_norm_b",
                     "q_a_norm", "kv_a_norm", "ffn_norm_exps",
                     # bitnet's sub-norms and per-tensor scales
                     "attn_sub_norm", "ffn_sub_norm", "wq_s", "wk_s", "wv_s", "wo_s",
                     "ffn_gate_s", "ffn_up_s", "ffn_down_s",
                     # the per-layer input block's norm and the output scale;
                     # AltUp's router, coefficients and scale and LAuReL's
                     # low-rank pair and norm (loader.py:355-358)
                     "per_layer_post_norm", "out_scale", *ALTUP_TENSORS.values()}

GLOBAL_TENSORS = {
    "token_embd.weight": "tok_embd",
    "output.weight": "output",
    "output_norm.weight": "output_norm",
    "output_norm.bias": "output_norm_b",
    "rope_freqs.weight": "rope_freqs",
    "position_embd.weight": "pos_embd",  # gpt2, starcoder: learned positions
    "token_embd_norm.weight": "tok_norm",  # bloom: a layernorm on the embedding
    "token_embd_norm.bias": "tok_norm_b",
    # gemma4's and gemma3n's per-layer token stream: the (vocab, n_layer x P)
    # table, the projection of the embedded input and its norm; gemma3n's
    # AltUp stream expansion and merge (loader.py:207-212)
    "per_layer_token_embd.weight": "per_layer_tok_embd",
    "per_layer_model_proj.weight": "per_layer_model_proj",
    "per_layer_proj_norm.weight": "per_layer_proj_norm",
    "altup_proj.weight": "altup_proj",
    "altup_unembd_proj.weight": "altup_unembd_proj",
}
_FLOAT_GLOBALS = {"output_norm", "output_norm_b", "rope_freqs", "pos_embd", "tok_norm",
                  "tok_norm_b", "per_layer_proj_norm", "altup_proj", "altup_unembd_proj"}


def _to_float_array(g: GGUFFile, name: str) -> np.ndarray:
    """Small norm/bias tensors -> f32 numpy."""
    ti = g.tensors[name]
    raw = g.tensor_data(name)
    n_in = ti.shape[0]
    rows = ti.n_elements // n_in
    return dequantize(raw.reshape(rows, -1), ti.ggml_type).reshape(ti.np_shape).astype(np.float32)


def _load_qtensor(g: GGUFFile, name: str) -> QTensor:
    ti = g.tensors[name]
    return qtensor_from_bytes(g.tensor_data(name), ti.ggml_type, ti.np_shape)


def _stack_qtensors(items: list[QTensor]) -> QTensor:
    """Stack per-layer QTensors (same qtype/shape) along a new leading axis."""
    t0 = items[0]
    if not all(t.qtype == t0.qtype and t.shape == t0.shape for t in items):
        raise ValueError("cannot stack QTensors of different types or shapes")
    data = {k: torch.stack([t.data[k] for t in items]) for k in t0.data}
    return QTensor(t0.qtype, (len(items),) + t0.shape, data)


def _place(v, device):
    if isinstance(v, QTensor):
        return v.to(device)
    if isinstance(v, dict):
        return {k: _place(x, device) for k, x in v.items()}
    if isinstance(v, list):
        return [_place(x, device) for x in v]
    return v.to(device)


def _mla_prepare(layers: dict, cfg) -> dict:
    """The MLA absorption banks as dense f32 tensors (loader.py:268-290):
    wk_b (L, H, kv_lora, nope), so that q_nope absorbs into the latent
    space, and wv_b (L, H, v, kv_lora), which lifts the attention's output
    back out. A legacy attn_kv_b {kv_lora, H * (nope + v)} is split here;
    quantized split banks are dequantized."""
    nope = cfg.head_dim - cfg.rope_dim
    H, v, lora = cfg.n_head, cfg.head_dim_v, cfg.kv_lora_rank
    f32 = lambda t: t.dequant(torch.float32) if isinstance(t, QTensor) else t.float()
    if "wkv_b" in layers:
        if {"wk_b", "wv_b"} & set(layers):
            raise NotImplementedError("MLA layers with both attn_kv_b and attn_k_b/attn_v_b")
        kvb = f32(layers.pop("wkv_b"))
        kvb = kvb.reshape(kvb.shape[0], H, nope + v, lora)
        layers["wk_b"] = kvb[:, :, :nope, :].transpose(2, 3).contiguous()
        layers["wv_b"] = kvb[:, :, nope:, :].contiguous()
    for k, want in (("wk_b", (H, lora, nope)), ("wv_b", (H, v, lora))):
        if k not in layers:
            continue
        layers[k] = f32(layers[k]).contiguous()
        if tuple(layers[k].shape[1:]) != want:
            raise ValueError(f"MLA {k}: shape {tuple(layers[k].shape)}, want (L,) + {want}")
    return layers


def load_model(path: str, device="cuda"):
    """Returns (config, params dict, GGUFFile) with params on ``device``.

    Runs on the card unless the caller passes device="cpu"; without a card
    the default raises. QKV and gate/up are fused into single kmajor weights
    (one kernel launch per pair) wherever their types match."""
    device = resolve_device(device)
    g = GGUFFile(path)
    cfg = config_from_gguf(g)
    params: dict[str, Any] = {}
    layer_tensors = {**LAYER_TENSORS, **(MLA_TENSORS if cfg.kv_lora_rank else {}),
                     **(CHEXP_TENSORS if cfg.n_group_experts > 0 else {}),
                     **(ARCTIC_TENSORS if cfg.moe_dense_parallel == "arctic" else {}),
                     **(BITNET_TENSORS if cfg.sub_norms else {}),
                     **OUT_NORM_TENSORS.get(cfg.arch, {}),
                     **(PLE_TENSORS if cfg.n_embd_per_layer or cfg.gemma4_attn else {}),
                     **(ALTUP_TENSORS if cfg.altup_n else {})}
    known = set(GLOBAL_TENSORS) | {f"blk.{i}.{s}" for i in range(cfg.n_layer)
                                   for s in layer_tensors}
    known |= {f"blk.{i}.{s}" for i in range(cfg.n_layer)
              for s in UNREAD_TENSORS.get(cfg.arch, ())}
    # the NextN layers past n_layer (config_from_gguf took them off it) are
    # not read, as the JAX loader walks range(n_layer) (loader.py:341)
    n_blocks = int(g.get(f"{cfg.arch}.block_count", cfg.n_layer))
    nextn = tuple(f"blk.{i}." for i in range(cfg.n_layer, n_blocks))
    unknown = sorted(t for t in set(g.tensors) - known if not t.startswith(nextn))
    if unknown:
        raise NotImplementedError(
            f"tensors outside the dense decoder and MoE paths: {unknown[:8]}")

    for tname, key in GLOBAL_TENSORS.items():
        if tname not in g.tensors:
            continue
        if key in _FLOAT_GLOBALS:
            params[key] = torch.from_numpy(_to_float_array(g, tname))
        else:
            params[key] = _load_qtensor(g, tname)
    if "output" not in params:
        params["output"] = params["tok_embd"]  # tied embeddings
        cfg.tie_embeddings = True

    per_key: dict[str, dict[int, Any]] = {}
    nks = cfg.n_layer_kv_from_start
    dead = SHARED_KV_DEAD if cfg.altup_n and 0 <= nks < cfg.n_layer else frozenset()
    for i in range(cfg.n_layer):
        for suffix, key in layer_tensors.items():
            tname = f"blk.{i}.{suffix}"
            if tname not in g.tensors or (i >= nks and key in dead):
                continue
            if key in _FLOAT_LAYER_KEYS or (key in ("wk_b", "wv_b")
                                            and g.tensors[tname].ggml_type in _FLOAT_TYPES):
                per_key.setdefault(key, {})[i] = torch.from_numpy(_to_float_array(g, tname))
            else:
                per_key.setdefault(key, {})[i] = _load_qtensor(g, tname)

    shexp = sorted(SHEXP_KEYS & set(per_key))
    if shexp and (len(shexp) < len(SHEXP_KEYS) or any(
            set(per_key[k]) != set(per_key[shexp[0]]) for k in shexp)):
        names = [f"blk.{i}.{k}.weight" for k in shexp for i in sorted(per_key[k])]
        raise NotImplementedError(
            f"shared expert tensors {names[:8]}: the gated shared expert needs all of "
            f"{sorted(SHEXP_KEYS)} in the same layers")

    # per-layer quant types may change with depth (ftype policies bump some
    # layers): stack each contiguous segment of uniform signature
    def sig(i):
        return tuple(
            (k, v[i].qtype, v[i].shape) if isinstance(v[i], QTensor)
            else (k, "arr", tuple(v[i].shape))
            for k, v in sorted(per_key.items()) if i in v)

    bounds = [0] + [i for i in range(1, cfg.n_layer) if sig(i) != sig(i - 1)] + [cfg.n_layer]

    def build_group(lo, hi):
        layers: dict[str, Any] = {}
        for key, items in per_key.items():
            if lo not in items:
                continue
            seg = [items[i] for i in range(lo, hi)]
            if isinstance(seg[0], QTensor):
                layers[key] = _stack_qtensors(seg)
            else:
                layers[key] = torch.stack(seg)
        if cfg.arch == "glm4moe" and "post_attn_norm" in layers and "ffn_norm" not in layers:
            # glm4moe's post_attention_norm is its pre-FFN norm (loader.py:410-414)
            layers["ffn_norm"] = layers.pop("post_attn_norm")
        if cfg.kv_lora_rank:
            layers = _mla_prepare(layers, cfg)
        return fuse_layer_weights(layers, cfg)

    groups = [build_group(lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:])]
    params["layers"] = groups[0] if len(groups) == 1 else {"__groups__": groups}
    params = {k: _place(v, device) for k, v in params.items()}
    if cfg.tie_embeddings:
        params["output"] = params["tok_embd"]
    return cfg, params, g
