"""Fused decode layer block: kernel D.

Counterpart of tpullm/ops/layer_kernel.py: wo + residual + rmsnorm +
gate/up + activation + down + residual (and, folded, the next layer's
attention rmsnorm and fused QKV) as ONE launch per decode layer. The
hand-written cooperative CUDA kernel lives in csrc/layer_kernel.cu; each
of its phases is split-K over (column tile, K slab) work items, and
``layer_plan`` picks each pool's slabs. The plain version composes plain
qmm, rmsnorm and the activation with the TPU kernel's rounding points: the
residual stays f32; h2, hmid and the next layer's normed input are rounded
to bf16.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..gguf.constants import GGMLType
from ..quant.kmajor import KM_SPECS
from . import _cuda
from .fuse import pad256
from .qmm import qmm_plain, tile_k_ok

_ACT_CODES = {"silu": 0, "gelu": 1, "swiglu_oai": 2}
MAX_ROWS = 16  # the kernel serves B*T <= 16 (layer_kernel.py:438)
LAYER_TILE = 128  # columns of a work item (csrc/layer_kernel.cu TC)
LAYER_WARPS_K = 2  # warps along K in an item (csrc/layer_kernel.cu LK)
LAYER_MAX_ROWS = 512  # packed rows per K slab (bounds x's slab in shared memory)
BLOCKS_PER_SM = 4  # resident blocks an SM (csrc/layer_kernel.cu L_MIN_BLOCKS)
N_COUNTERS = 1024  # per-tile arrival counters (csrc/layer_kernel.cu MAX_TILES)
# layer_plan's cost model, in units of one k step of a warp: an item's fixed
# cost (first loads, scale rows, x's slab, the partial store) and one round
# of 8 slabs in the tile's reduce, which the phase's last tile waits out
ITEM_COST = 4
REDUCE_ROUND_COST = 2


def _best_tk(K: int, qtype, cap: int) -> int:
    """Largest legal K-tile dividing K under the cap (the JAX package's
    structural gate, layer_kernel.py:42-52)."""
    best = 0
    t = 128
    while t <= min(K, cap):
        if K % t == 0 and tile_k_ok(qtype, t, K):
            best = t
        t += 128
    return best


def supported(cfg, qw) -> bool:
    """Structural gate: llama-style sequential residual FFN block."""
    if not all(k in qw for k in ("wo", "ffn_gateup", "ffn_down")):
        return False
    if cfg.n_expert or cfg.parallel_residual or cfg.post_norms:
        return False
    if cfg.norm_type != "rmsnorm":
        return False
    if cfg.act_fn == "xielu" or cfg.attn_gate_proj or cfg.moe_dense_parallel:
        return False
    for k in ("wo", "ffn_gateup", "ffn_down"):
        if qw[k].layout != "kmajor":
            return False
        K = qw[k].shape[-1]
        tk = _best_tk(K, GGMLType(qw[k].qtype), 8192)
        if not tk or K % tk:
            return False
    return True


def _act(name: str, g, u):
    gf = g.to(torch.float32)
    uf = u.to(torch.float32)
    if name == "silu":
        return (torch.nn.functional.silu(gf) * uf).to(torch.bfloat16)
    if name == "gelu":
        return (torch.nn.functional.gelu(gf, approximate="tanh") * uf).to(torch.bfloat16)
    if name == "swiglu_oai":
        gf = torch.clamp(gf, max=7.0)
        uf = torch.clamp(uf, -7.0, 7.0)
        return (gf * torch.sigmoid(1.702 * gf) * (uf + 1.0)).to(torch.bfloat16)
    raise ValueError(name)


def _norm_bf16(x, w, eps):
    var = (x * x).mean(dim=1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w[None, :].to(torch.float32)).to(torch.bfloat16)


def _plain(att, resid, ffn_norm, qw, layer, cfg, attn_norm=None):
    """Plain version of ffn_block (attn_norm None) / ffn_block_qkv."""
    B, T, D = resid.shape
    M = B * T
    Hd = att.shape[-1]
    n_ff = cfg.n_ff
    nffp = pad256(n_ff)
    wo, gu, dn = qw["wo"], qw["ffn_gateup"], qw["ffn_down"]
    a = att.reshape(M, Hd).to(torch.bfloat16)
    x = resid.reshape(M, D).to(torch.bfloat16).to(torch.float32)
    x2 = x + qmm_plain(a, wo.data, wo.qtype, wo.n_out, torch.float32, layer)[:, :D]
    h2 = _norm_bf16(x2, ffn_norm, cfg.rms_eps)
    y = qmm_plain(h2, gu.data, gu.qtype, gu.n_out, torch.float32, layer)
    hmid = _act(cfg.act_fn, y[:, :n_ff], y[:, nffp: nffp + n_ff])
    x_out = x2 + qmm_plain(hmid, dn.data, dn.qtype, dn.n_out, torch.float32, layer)[:, :D]
    out = x_out.to(torch.bfloat16).reshape(B, T, D)
    if attn_norm is None:
        return out
    qk = qw["wqkv"]
    nxt = min(layer + 1, qk.data["q"].shape[0] - 1)
    hq = _norm_bf16(x_out, attn_norm[nxt], cfg.rms_eps)
    qkv = qmm_plain(hq, qk.data, qk.qtype, qk.data["q"].shape[-1], torch.float32, nxt)
    return out, qkv.to(torch.bfloat16).reshape(B, T, -1)


@functools.cache
def layer_plan(qtype, K: int, Npad: int, blocks: int) -> tuple[int, int]:
    """-> (scale groups per K slab, number of slabs) of one pool of kernel
    D, whose persistent grid of ``blocks`` walks the pool's (tile, slab)
    items: whole scale groups a slab, at most LAYER_MAX_ROWS packed rows,
    and the least of waves x (ITEM_COST + k steps a warp) + REDUCE_ROUND_COST
    x rounds of the last tile's reduce."""
    spec = KM_SPECS[GGMLType(qtype)]
    P = 2 if spec.kind == "u4" else 1
    G = K // P // spec.gs
    tiles = Npad // LAYER_TILE
    steps = spec.gs // (16 // P)  # k16 steps of a scale group
    best = None
    for gps in range(1, G + 1):
        if G % gps or (gps > 1 and gps * spec.gs > LAYER_MAX_ROWS):
            continue
        nS = G // gps
        cost = (math.ceil(tiles * nS / blocks) * (ITEM_COST + gps * steps / LAYER_WARPS_K)
                + REDUCE_ROUND_COST * math.ceil(nS / 8))
        if best is None or cost < best[0]:
            best = (cost, gps, nS)
    return best[1], best[2]


def scratch_floats(M: int, D: int, n_ff: int, Npad_D: int, parts) -> int:
    """Floats of kernel D's scratch, carved as csrc/layer_kernel.cu does:
    x2 and x_out (M, D) f32, two sums of squares (Npad_D / LAYER_TILE
    tiles, MAX_ROWS each), hmid (M, n_ff) bf16, then the partials of the
    largest pool; ``parts`` holds each pool's (slabs, Npad). Each part
    starts 16-byte aligned."""
    a4 = lambda n: -(-n // 4) * 4
    part = max(nS * M * Npad for nS, Npad in parts)
    return (2 * a4(M * D) + 2 * (Npad_D // LAYER_TILE) * MAX_ROWS
            + a4(-(-M * n_ff // 2)) + part)


@functools.cache
def _grid_blocks(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count * BLOCKS_PER_SM


@functools.cache
def _counters(index: int):
    """The arrival counters of one device, for launches outside an owner's
    ``_cuda.counters_scope``: zero at first use, and each launch leaves them
    zero (the last block of each tile resets its counter). Such launches
    on a device run one at a time, on one stream. Made by an eager launch: a
    buffer first made inside a graph capture would live in the graph's
    private pool while eager launches share it, so that raises."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("layer_kernel: the arrival counters would be made during a CUDA "
                           "graph capture; launch the kernel once before capturing")
    return torch.zeros(N_COUNTERS, dtype=torch.int32, device=torch.device("cuda", index))


def _launch(att, resid, ffn_norm, qw, layer: int, cfg, attn_norm=None):
    B, T, D = resid.shape
    M = B * T
    if M > MAX_ROWS:
        raise ValueError(f"layer kernel serves B*T <= {MAX_ROWS}, got {M}")
    if cfg.act_fn not in _ACT_CODES:
        raise ValueError(cfg.act_fn)
    Hd = att.shape[-1]
    n_ff = cfg.n_ff
    pools = [qw["wo"], qw["ffn_gateup"], qw["ffn_down"]]
    Ks = [Hd, D, n_ff]
    descs = [_cuda.km_descriptor({k: v[layer] for k, v in p.data.items()}, p.qtype, K)
             for p, K in zip(pools, Ks)]
    fold = attn_norm is not None
    dev = resid.device
    out = torch.empty((M, D), dtype=torch.bfloat16, device=dev)
    qkv = anrm = None
    if fold:
        qk = qw["wqkv"]
        nxt = min(layer + 1, qk.data["q"].shape[0] - 1)
        descs.append(_cuda.km_descriptor({k: v[nxt] for k, v in qk.data.items()},
                                         qk.qtype, D))
        pools.append(qk)
        Ks.append(D)
        anrm = attn_norm[nxt].to(torch.float32).contiguous()
        _cuda.require_cuda(anrm, "attn_norm")
        qkv = torch.empty((M, qk.data["q"].shape[-1]), dtype=torch.bfloat16, device=dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    counters = _cuda.scoped_counters("layer_kernel")
    if counters is None:
        counters = _counters(index)
    elif counters.numel() < N_COUNTERS:
        raise ValueError(f"layer_kernel: {counters.numel()} arrival counters, "
                         f"{N_COUNTERS} needed")
    blocks = _grid_blocks(index)
    npads = [p.data["q"].shape[-1] for p in pools]
    plans = [layer_plan(p.qtype, K, n, blocks) for p, K, n in zip(pools, Ks, npads)]
    att2 = att.reshape(M, Hd).to(torch.bfloat16).contiguous()
    res2 = resid.reshape(M, D).to(torch.bfloat16).contiguous()
    nrm = ffn_norm.to(torch.float32).contiguous()
    for t, what in ((att2, "att"), (res2, "resid"), (nrm, "ffn_norm")):
        _cuda.require_cuda(t, what)
    nscratch = scratch_floats(M, D, n_ff, npads[0],
                              [(nS, n) for (_, nS), n in zip(plans, npads)])
    scratch = torch.empty(nscratch, dtype=torch.float32, device=dev)
    plan = (ctypes.c_int * 8)(*[v for p in plans for v in p])
    err = _cuda.lib().tpq_layer_kernel(
        *_cuda.c_km(descs), plan, att2.data_ptr(), res2.data_ptr(), nrm.data_ptr(),
        anrm.data_ptr() if fold else None, out.data_ptr(),
        qkv.data_ptr() if fold else None, scratch.data_ptr(),
        counters.data_ptr(),
        M, D, Hd, n_ff, _ACT_CODES[cfg.act_fn], int(fold), nscratch, float(cfg.rms_eps),
        _cuda.stream_ptr(out))
    _cuda.COUNTS["layer_kernel"] += 1
    _cuda.check(err, "layer_kernel (cooperative launch)")
    if not fold:
        return out.reshape(B, T, D)
    return out.reshape(B, T, D), qkv.reshape(B, T, -1)


def ffn_block(att, resid, ffn_norm, qw, layer: int, cfg):
    """att (B, T, Hd), resid (B, T, D) -> layer output (B, T, D) bf16.

    Decode path (B*T <= 16). qw holds layer-stacked kmajor wo / ffn_gateup /
    ffn_down; ffn_norm is this layer's (D,) rmsnorm weight."""
    if not resid.is_cuda:
        return _plain(att, resid, ffn_norm, qw, layer, cfg)
    return _launch(att, resid, ffn_norm, qw, layer, cfg)


def ffn_block_qkv(att, resid, ffn_norm, attn_norm, qw, layer: int, cfg):
    """Folded variant: returns (layer output (B,T,D), NEXT layer's fused
    qkv (B,T,Nqkv_pad)), both bf16. attn_norm is the stacked (L, D)
    attention rmsnorm weight; the last layer folds itself again, as the
    TPU kernel clamps the next index."""
    if not resid.is_cuda:
        return _plain(att, resid, ffn_norm, qw, layer, cfg, attn_norm)
    return _launch(att, resid, ffn_norm, qw, layer, cfg, attn_norm)
