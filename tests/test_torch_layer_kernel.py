"""The plain version of the port's decode layer kernel (kernel D) held
against the JAX package's fused layer-block Pallas kernel in interpret
mode, plain and folded, on CPU."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGMLType
from tpullm.ops.fuse import fuse_layer_weights as jfuse
from tpullm.ops.layer_kernel import ffn_block as jffn_block
from tpullm.ops.layer_kernel import ffn_block_qkv as jffn_block_qkv
from tpullm.ops.layer_kernel import supported as jsupported
from tpullm.ops.qtensor import QTensor as JQTensor
from tpullm.utils.synth import synth_qparams
from tpullm_torch.models.config import ModelConfig
from tpullm_torch.ops.fuse import pad256
from tpullm_torch.ops.layer_kernel import (LAYER_MAX_ROWS, LAYER_TILE, MAX_ROWS, ffn_block,
                                           ffn_block_qkv, layer_plan, scratch_floats,
                                           supported)
from tpullm_torch.ops.qtensor import QTensor
from tpullm_torch.quant.kmajor import KM_SPECS

torch.set_num_threads(2)


def _setup(qtype, seed):
    jcfg, params = synth_qparams(vocab_size=128, n_embd=512, n_layer=3, n_head=4,
                                 n_head_kv=2, n_ff=512, qtype=qtype, seed=seed)
    layers = jfuse(params["layers"])
    jqw = {k: v for k, v in layers.items() if isinstance(v, JQTensor)}
    qw = {k: QTensor(v.qtype, v.shape, {n: torch.from_numpy(np.array(a))
                                        for n, a in v.data.items()})
          for k, v in jqw.items()}
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return jcfg, layers, jqw, cfg, qw


def _nmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / max((b ** 2).mean(), 1e-30))


def _acts(cfg, seed, B=4):
    r = np.random.default_rng(seed)
    Hd = cfg.n_head * cfg.head_dim_v
    att = jnp.asarray(r.standard_normal((B, 1, Hd)) * 0.1, jnp.bfloat16)
    x = jnp.asarray(r.standard_normal((B, 1, cfg.n_embd)) * 0.1, jnp.bfloat16)
    t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return att, x, t(att), t(x)


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K])
def test_ffn_block_plain_vs_pallas(qtype):
    """The Pallas kernel rounds each dequantized tile to bf16; the plain
    version keeps f32 weights (and rounds h2 and hmid to bf16 at the same
    points): NMSE < 5e-4, tests/test_layer_kernel.py's bound."""
    jcfg, layers, jqw, cfg, qw = _setup(qtype, 3)
    assert supported(cfg, qw) == jsupported(jcfg, jqw) is True
    att, x, tatt, tx = _acts(cfg, 0)
    for li in (0, 2):
        want = np.asarray(jffn_block(att, x, layers["ffn_norm"][li], jqw, jnp.int32(li),
                                     jcfg, interpret=True), np.float32)
        nrm = torch.from_numpy(np.array(layers["ffn_norm"][li]))
        got = ffn_block(tatt, tx, nrm, qw, li, cfg).float().numpy()
        assert got.shape == want.shape == (4, 1, 512)
        assert _nmse(got, want) < 5e-4


@pytest.mark.parametrize("layer", [1, 2])
def test_ffn_block_qkv_plain_vs_pallas(layer):
    """Folded variant (the last layer folds itself again). x_out at
    NMSE < 5e-4 and the next layer's qkv at NMSE < 5e-3, the bounds of
    tests/test_layer_kernel.py."""
    jcfg, layers, jqw, cfg, qw = _setup(GGMLType.Q4_K, 11)
    att, x, tatt, tx = _acts(cfg, 2)
    anrm = layers["attn_norm"]
    wx, wqkv = jffn_block_qkv(att, x, layers["ffn_norm"][layer], anrm, jqw,
                              jnp.int32(layer), jcfg, interpret=True)
    gx, gqkv = ffn_block_qkv(tatt, tx, torch.from_numpy(np.array(layers["ffn_norm"][layer])),
                             torch.from_numpy(np.array(anrm)), qw, layer, cfg)
    assert gqkv.shape == tuple(wqkv.shape)
    assert _nmse(gx.float().numpy(), np.asarray(wx, np.float32)) < 5e-4
    assert _nmse(gqkv.float().numpy(), np.asarray(wqkv, np.float32)) < 5e-3


# (D, Hd, n_ff, Nqkv_pad) of Llama-3-8B, Llama-2-7B, Llama-2-13B and the
# tests' 512 widths
_WIDTHS = {"8B": (4096, 4096, 14336, 6144), "7B": (4096, 4096, 11008, 12288),
           "13B": (5120, 5120, 13824, 15360), "512": (512, 512, 1024, 1024)}


def _pools(width):
    """(K, Npad) of wo, gateup, down and qkv at a width."""
    D, Hd, n_ff, nq = _WIDTHS[width]
    return [(Hd, pad256(D)), (D, 2 * pad256(n_ff)), (n_ff, pad256(D)), (D, nq)]


@pytest.mark.parametrize("width", sorted(_WIDTHS))
@pytest.mark.parametrize("qtype", sorted(KM_SPECS, key=lambda t: t.name))
def test_layer_plan_covers_k_with_whole_groups(width, qtype):
    """Kernel D's slab plan: every pool's K split into slabs of whole scale
    groups (gps x nS = the groups of a plane), a slab's packed rows within
    LAYER_MAX_ROWS (or one group), and whole k16 steps a slab."""
    spec = KM_SPECS[qtype]
    P = 2 if spec.kind == "u4" else 1
    for K, Npad in _pools(width):
        assert Npad % LAYER_TILE == 0
        gps, nS = layer_plan(qtype, K, Npad, 132 * 6)
        assert gps * nS * spec.gs * P == K
        assert gps == 1 or gps * spec.gs <= LAYER_MAX_ROWS
        assert gps * spec.gs % (16 // P) == 0


@pytest.mark.parametrize("width", sorted(_WIDTHS))
@pytest.mark.parametrize("M", [1, 4, 16])
def test_layer_scratch_holds_every_partial(width, M):
    """The scratch kernel D asks for holds the residual streams, the sums
    of squares, hmid and every pool's slab partials (nS, M, Npad), at
    Q4_K and Q6_K plans."""
    D, Hd, n_ff, _ = _WIDTHS[width]
    pools = _pools(width)
    for qtype in (GGMLType.Q4_K, GGMLType.Q6_K):
        parts = [(layer_plan(qtype, K, Npad, 132 * 6)[1], Npad) for K, Npad in pools]
        total = scratch_floats(M, D, n_ff, pools[0][1], parts)
        fixed = 2 * M * D + 2 * (pools[0][1] // LAYER_TILE) * MAX_ROWS + M * n_ff / 2
        for nS, Npad in parts:
            assert total >= fixed + nS * M * Npad
        assert total <= fixed + max(nS * M * Npad for nS, Npad in parts) + 16
