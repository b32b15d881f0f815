"""Weight fusion: concatenate kmajor QTensors along the output (column) axis.

Counterpart of tpullm/ops/fuse.py. One fused kernel launch replaces 2-3;
each part keeps its own 256-padded column range, so output offsets follow
from the logical sizes.
"""
from __future__ import annotations

import torch

from .qtensor import QTensor


def pad256(n: int) -> int:
    return (n + 255) // 256 * 256


def can_fuse(qts: list) -> bool:
    if not qts or any(q is None for q in qts):
        return False
    t0 = qts[0]
    return all(
        q.layout == "kmajor"
        and q.qtype == t0.qtype
        and q.shape[-1] == t0.shape[-1]
        and q.shape[:-2] == t0.shape[:-2]
        and set(q.data) == set(t0.data)
        for q in qts
    )


def concat_kmajor(qts: list[QTensor]) -> QTensor:
    """Fuse along n_out. Every part is already column-padded to 256 by
    pack_kmajor; the fused logical n_out is the padded total."""
    if not can_fuse(qts):
        raise ValueError("weights are not fuseable")
    t0 = qts[0]
    data = {k: torch.cat([q.data[k] for q in qts], dim=-1) for k in t0.data}
    n_total = sum(pad256(q.n_out) for q in qts)
    return QTensor(t0.qtype, t0.shape[:-2] + (n_total, t0.shape[-1]), data)


def fuse_layer_weights(layers: dict, cfg=None) -> dict:
    """Replace (wq, wk, wv) -> wqkv and (ffn_gate, ffn_up) -> ffn_gateup when
    fuseable; the unfused originals are dropped. gemma3n's gate and up fuse
    as every K-major dense FFN's do, and its AltUp layer slices ffn_gateup at
    n_ff (models/llama.py:gate_up): the port's own route, where the JAX
    AltUp layer reads ffn_gate and ffn_up and fails on a fused load
    (llama.py:1114-1115; ROADMAP §3). A GGUF-combined [gate; up]
    (one ffn_up of 2 x n_ff rows: phi3, chatglm, plamo3) that is K-major with
    n_ff a multiple of 256 is, byte for byte, concat_kmajor of its halves
    (each fills its own 256-padded column range): it is renamed ffn_gateup,
    so that the layer kernel takes it. That is the port's own route: the JAX
    loader keeps it as ffn_up, which its layer-kernel gate does not take
    (layer_kernel.py:411)."""
    out = dict(layers)
    qkv = [layers.get(k) for k in ("wq", "wk", "wv")]
    if can_fuse(qkv):
        out["wqkv"] = concat_kmajor(qkv)
        for k in ("wq", "wk", "wv"):
            del out[k]
    gu = [layers.get(k) for k in ("ffn_gate", "ffn_up")]
    if can_fuse(gu) and (cfg is None or gu[0].n_out == cfg.n_ff):
        out["ffn_gateup"] = concat_kmajor(gu)
        for k in ("ffn_gate", "ffn_up"):
            del out[k]
    up = layers.get("ffn_up")
    if (cfg is not None and cfg.ffn_gate and "ffn_gate" not in layers and up is not None
            and up.layout == "kmajor" and up.n_out == 2 * cfg.n_ff and cfg.n_ff % 256 == 0):
        out["ffn_gateup"] = out.pop("ffn_up")
    return out
