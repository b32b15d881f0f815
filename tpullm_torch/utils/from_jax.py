"""Carry a model's parameters across from the JAX package.

The input is plain nested data, so this module sees no JAX type:
- the config as ``dataclasses.asdict(ModelConfig)``;
- a quantized (or dense) weight as
  ``{"qtype": int, "shape": tuple, "data": {key: np.ndarray}}``;
- a float tensor as ``np.ndarray``;
- dicts (and the ``"__groups__"`` list of layer groups) as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..models.config import ModelConfig
from ..models.llama import SCALE_KEYS
from ..ops._cuda import resolve_device
from ..ops.qtensor import QTensor

_QT_KEYS = {"qtype", "shape", "data"}


def _convert(v, device):
    if isinstance(v, dict) and set(v) == _QT_KEYS:
        data = {k: torch.from_numpy(np.array(a)).to(device) for k, a in v["data"].items()}
        return QTensor(GGMLType(int(v["qtype"])), tuple(int(s) for s in v["shape"]), data)
    if isinstance(v, dict):
        return {k: _convert(x, device) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_convert(x, device) for x in v]
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.array(v)).to(device)
    raise TypeError(f"params_from_numpy: unexpected leaf {type(v).__name__}")


def _scales_as_arrays(layers):
    """BitNet's per-tensor scales (wq_s, ..., ffn_down_s) come from the JAX
    loader as F32 weights, since its float rule (loader.py:350-366) misses
    their names, and its forward, which reads them among the float arrays,
    then passes over them (ROADMAP §3): each is carried across as the f32
    (L, 1) array the port's loader holds, so the port applies it."""
    if "__groups__" in layers:
        return {"__groups__": [_scales_as_arrays(g) for g in layers["__groups__"]]}
    return {k: v["data"]["w"] if (k in SCALE_KEYS and isinstance(v, dict) and set(v) == _QT_KEYS)
            else v for k, v in layers.items()}


def params_from_numpy(cfg_dict: dict, params: dict, device="cuda"):
    """-> (ModelConfig, params on ``device``) for the port's forward. Layer
    tensors come across by name, the post-norms (gemma2/3's post_attn_norm,
    post_ffn_norm) and MLA's (wq_a, q_a_norm, wq_b, wkv_a, kv_a_norm, and
    wk_b and wv_b as the f32 arrays of the JAX _mla_prepare) among them, and
    so do the per-layer-embedding Gemmas' tensors: the token stream's tables
    (per_layer_tok_embd, per_layer_model_proj and the f32
    per_layer_proj_norm), AltUp's f32 stream projections and each layer's
    per-layer input block, output scale and f32 AltUp and LAuReL arrays,
    and the dense singles' tensors: chameleon's (H, hd) q/k norms and their
    biases, bitnet's sub-norms and its per-tensor scales (as f32 arrays,
    ``_scales_as_arrays``). A config with tied embeddings (gemma) gets
    its lm_head as the embedding's own QTensor, as the port's loader binds
    it, not as a second copy of the same weight."""
    device = resolve_device(device)
    cfg = ModelConfig(**cfg_dict)
    if "layers" in params:
        params = dict(params, layers=_scales_as_arrays(params["layers"]))
    out = {k: _convert(v, device) for k, v in params.items() if not (
        cfg.tie_embeddings and k == "output")}
    if cfg.tie_embeddings:
        out["output"] = out["tok_embd"]
    return cfg, out


def kv_cache_from_numpy(k, v, ks=None, vs=None, device="cuda", kw=None, vw=None,
                        ring: int = 0):
    """A JAX KVCache's arrays (k, v and, for the int8 cache, the ks/vs row
    scales, all as numpy; head-major (L, B, Hkv, S, D)) -> the port's
    KVCache on ``device``; a dual cache also brings its ring banks kw/vw
    (L_swa, B, Hkv, ring, D) and ``ring``. bf16 arrives as ml_dtypes
    bfloat16 and is carried through its bits."""
    from ..models.llama import KVCache

    device = resolve_device(device)

    def conv(a):
        if a is None:
            return None
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(np.array(a)).to(device)

    return KVCache(conv(k), conv(v), conv(ks), conv(vs), conv(kw), conv(vw), int(ring))
