"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card, at small shapes. Every test here needs a CUDA card and skips
without one (decided inside the ``cuda`` fixture). Run on the card with:

    python -m pytest -m gpu tests/test_torch_gpu.py -q
"""
import dataclasses

import pytest
import torch

from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.models.config import ModelConfig
from tpullm_torch.ops import _cuda
from tpullm_torch.ops import flash_attention as fa
from tpullm_torch.ops import flash_decode as fd
from tpullm_torch.ops.flash_attention import alibi_of, flash_attention, masked_attention
from tpullm_torch.ops.layer_kernel import _plain as layer_plain
from tpullm_torch.ops.layer_kernel import ffn_block, ffn_block_qkv
from tpullm_torch.ops.moe_gmm import grouped_qmm, grouped_qmm_plain, live_tiles, sort_by_expert
from tpullm_torch.ops.qmm import qmm_kmajor, qmm_plain
from tpullm_torch.quant.kmajor import KM_SPECS
from tpullm_torch.utils.synth import random_kmajor

pytestmark = pytest.mark.gpu

QTYPES = [GGMLType.Q4_K, GGMLType.Q6_K]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _nmse(a, b):
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).mean() / (b ** 2).mean().clamp_min(1e-30))


def test_build_reports_ptxas(cuda):
    """Every kernel is compiled, and the 128 f32 sums a thread of kernels B
    and F (one body), kernel C's S and O accumulators (both head-dim
    instances, the ALiBi term among their paths), kernel E's fragments and
    running sums (every instance) and kernel A's mma
    accumulators, prefetched q words and group scales stay in registers:
    ptxas reports 0 spill bytes for each of their builds."""
    info = _cuda.build()
    names = " ".join(n for n, _, _ in info["ptxas"])
    for k in ("qmm_splitk_kernel", "qmm_wgmma_kernel", "flash_kernel", "layer_kernel",
              "moe_gmm_kernel", "flash_decode_kernel"):
        assert k in names or info["cached"], (k, names)
    for k in ("qmm_wgmma_kernel", "moe_gmm_kernel", "flash_kernel", "qmm_splitk_kernel",
              "flash_decode_kernel"):
        b = [(n, spill) for n, _, spill in info["ptxas"] if k in n]
        assert b and all(spill == 0 for _, spill in b), (k, b)
    # kernel C's instances at head dims 128 and 256 (O of 64 x 256 is 128
    # f32 a consumer thread there) are each built without spills
    for hd in (128, 256):
        assert f"flash_kernelILi{hd}E" in names or info["cached"], (hd, names)


@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("M", [1, 4, 7, 8, 9, 16, 17, 32, 33, 64, 200])
@pytest.mark.parametrize("stacked", [False, True])
def test_qmm_kernel_vs_plain(cuda, qtype, M, stacked):
    """Kernel A (M <= 32) or B (M > 32) vs dequantize-then-matmul. Both
    round the weight to bf16 identically and write bf16; they differ in f32
    summation order and hence in rare last-bit flips of the bf16 output:
    NMSE < 1e-5. M 8/9, 16/17 and 32 are the edges of kernel A's 1, 2 and 4
    n8 tiles of batch rows."""
    g = torch.Generator(device=cuda).manual_seed(M)
    K = 1024
    qt = random_kmajor(qtype, [300, 200], K, (3,) if stacked else (), g, cuda)
    layer = 1 if stacked else None
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    before = dict(_cuda.COUNTS)
    y = qmm_kmajor(x, qt.data, qtype, qt.n_out, torch.bfloat16, layer)
    kernel = "qmm_splitk" if M <= 32 else "qmm"
    assert _cuda.COUNTS[kernel] == before[kernel] + 1
    want = qmm_plain(x, qt.data, qtype, qt.n_out, torch.bfloat16, layer)
    torch.cuda.synchronize()
    assert y.shape == want.shape == (M, qt.n_out)
    assert _nmse(y, want) < 1e-5


@pytest.mark.parametrize("qtype", sorted(KM_SPECS, key=lambda t: t.name))
@pytest.mark.parametrize("M", [1, 4, 8, 9, 16, 17, 32, 64, 200])
@pytest.mark.parametrize("stacked", [False, True])
def test_qmm_kernel_all_types(cuda, qtype, M, stacked):
    """Every K-major type through kernels A (M <= 32, each edge of its n8
    tiles) and B (same tolerance), flat and as layer 1 of a stack."""
    g = torch.Generator(device=cuda).manual_seed(int(qtype))
    qt = random_kmajor(qtype, [256], 1024, (2,) if stacked else (), g, cuda)
    layer = 1 if stacked else None
    x = torch.randn((M, 1024), generator=g, device=cuda).to(torch.bfloat16)
    y = qmm_kmajor(x, qt.data, qtype, qt.n_out, torch.bfloat16, layer)
    want = qmm_plain(x, qt.data, qtype, qt.n_out, torch.bfloat16, layer)
    torch.cuda.synchronize()
    assert _nmse(y, want) < 1e-5


@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("M", [48, 256, 512, 2048])
@pytest.mark.parametrize("K", [1024, 14336])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nout", [300, 299])
def test_qmm_prefill_tile_edges(cuda, qtype, M, K, out_dtype, nout):
    """Kernel B's 256-row tile at its edges: one mostly masked tile (48
    rows), exactly one (256), two (the server's 512-row chunk) and eight
    (the engine's 2048); 16 and 224 chunks of K (the long K wraps the ring
    of stages many times); 300 or 299 of 512 columns written (Nout < Npad;
    an odd Nout leaves odd rows' column pairs unaligned for paired stores);
    layer 2 of a 3-layer stack; bf16 and f32 out. Against the plain version
    within NMSE 1e-5 (the plain f32 product keeps f32 weights, the kernel
    rounds them to bf16), and two calls give identical bits."""
    g = torch.Generator(device=cuda).manual_seed(M + K)
    qt = random_kmajor(qtype, [300], K, (3,), g, cuda)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    before = _cuda.COUNTS["qmm"]
    y1 = qmm_kmajor(x, qt.data, qtype, nout, out_dtype, 2)
    y2 = qmm_kmajor(x, qt.data, qtype, nout, out_dtype, 2)
    want = qmm_plain(x, qt.data, qtype, nout, out_dtype, 2)
    torch.cuda.synchronize()
    assert _cuda.COUNTS["qmm"] == before + 2
    assert y1.shape == want.shape == (M, nout) and y1.dtype == out_dtype
    assert torch.equal(y1, y2)
    assert _nmse(y1, want) < 1e-5


def _attn_inputs(cuda, H, Hkv, T, S, S_full, valid_from, n_past, D=128):
    """K/V are a view of the first S slots of an S_full-slot cache (read in
    place, as the server's chunks read theirs); query slots start at
    n_past."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B = len(valid_from)
    q = torch.randn((B, T, H, D), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((B, Hkv, S_full, D), generator=g, device=cuda).to(torch.bfloat16)[:, :, :S]
    v = torch.randn((B, Hkv, S_full, D), generator=g, device=cuda).to(torch.bfloat16)[:, :, :S]
    vf = torch.tensor(valid_from, device=cuda)
    q_slots = n_past + torch.arange(T, device=cuda)[None].expand(B, T)
    positions = q_slots - vf[:, None]
    kv_positions = torch.arange(S, device=cuda)[None] - vf[:, None]
    return q, k, v, q_slots, kv_positions, positions, vf


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (20.0, 0), (0.0, 48)])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (6, 2), (8, 2), (8, 1)],
                         ids=["G1", "G2", "G3", "G4", "G8"])
@pytest.mark.parametrize("T,n_past,S,S_full", [
    (128, 0, 256, 256), (512, 0, 1024, 1024), (128, 1000, 2048, 2560),
    (512, 1000, 2048, 2560), (192, 128, 320, 448)],
    ids=["T128", "T512", "T128-deep", "T512-deep", "T192-odd"])
def test_flash_attention_kernel_vs_plain(cuda, softcap, window, heads, T, n_past, S, S_full):
    """Kernel C vs the masked softmax, for query-head groups of 1, 2, 3, 4
    and 8, with valid_from 0, 37 and 100 (straddling 64- and 128-key
    tiles). Query slots from 0 (over S = 2T), from 1000 (over a 2048-slot
    view of a 2560-slot cache: a depth that is no multiple of 64), or at
    T = 192 from 128 over a 320-slot view of a 448-slot cache: at G 1 and
    3 an odd count of (64-slot tile, head) pairs, so the last block holds
    one pair, and a view that ends halfway through a 128-key tile, which
    the last query slots reach. Both round p to bf16 before PV, at
    different points (unnormalized vs normalized): NMSE < 1e-4 over rows
    with a visible key; rows with none (left padding) are exactly 0 in
    both; two calls give identical bits."""
    H, Hkv = heads
    q, k, v, qs, kvp, pos, vf = _attn_inputs(cuda, H, Hkv, T, S, S_full, (0, 37, 100), n_past)
    cfg = ModelConfig(n_head=H, n_head_kv=Hkv, head_dim=128, head_dim_v=128,
                      attn_logit_softcap=softcap, sliding_window=window)
    before = _cuda.COUNTS["flash_attention"]
    got = flash_attention(q, k, v, qs, kvp, pos, vf, cfg, layer_is_swa=bool(window))
    again = flash_attention(q, k, v, qs, kvp, pos, vf, cfg, layer_is_swa=bool(window))
    want = masked_attention(q, k, v, qs, kvp, pos, vf, 1.0 / 128 ** 0.5, softcap, window)
    torch.cuda.synchronize()
    assert _cuda.COUNTS["flash_attention"] == before + 2
    assert torch.equal(got, again)
    for b, f in enumerate(vf.tolist()):
        live = qs[b] >= f
        assert torch.count_nonzero(got[b, ~live]) == 0
        assert torch.count_nonzero(want[b, ~live]) == 0
        assert _nmse(got[b, live], want[b, live]) < 1e-4


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (50.0, 0), (0.0, 48), (50.0, 100)])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (6, 2), (16, 8), (8, 1)],
                         ids=["G1", "G2", "G3", "G2-H16", "G8"])
@pytest.mark.parametrize("T,n_past,S,S_full", [
    (128, 0, 256, 256), (512, 0, 1024, 1024), (128, 1000, 2048, 2560),
    (512, 1000, 2048, 2560), (192, 128, 320, 448)],
    ids=["T128", "T512", "T128-deep", "T512-deep", "T192-odd"])
def test_flash_attention_kernel_head_dim_256(cuda, softcap, window, heads, T, n_past, S,
                                             S_full):
    """Kernel C's head-dim-256 instance (64-key stages) against the masked
    softmax over the T/S edges of the 128 cases above, with Gemma's softcap
    of 50 and windows that bite: NMSE < 1e-4 over rows with a visible key,
    rows with none exactly 0 in both, two calls bit-identical."""
    H, Hkv = heads
    q, k, v, qs, kvp, pos, vf = _attn_inputs(cuda, H, Hkv, T, S, S_full, (0, 37, 100), n_past,
                                             D=256)
    cfg = ModelConfig(n_head=H, n_head_kv=Hkv, head_dim=256, head_dim_v=256,
                      attn_logit_softcap=softcap, sliding_window=window)
    before = _cuda.COUNTS["flash_attention"]
    got = flash_attention(q, k, v, qs, kvp, pos, vf, cfg, layer_is_swa=bool(window))
    again = flash_attention(q, k, v, qs, kvp, pos, vf, cfg, layer_is_swa=bool(window))
    want = masked_attention(q, k, v, qs, kvp, pos, vf, 1.0 / 256 ** 0.5, softcap, window)
    torch.cuda.synchronize()
    assert _cuda.COUNTS["flash_attention"] == before + 2
    assert torch.equal(got, again)
    for b, f in enumerate(vf.tolist()):
        live = qs[b] >= f
        assert torch.count_nonzero(got[b, ~live]) == 0
        assert torch.count_nonzero(want[b, ~live]) == 0
        assert _nmse(got[b, live], want[b, live]) < 1e-4


@pytest.mark.parametrize("heads", [(4, 4), (8, 1), (48, 1)], ids=["G1", "G8", "G48"])
@pytest.mark.parametrize("T,n_past,S,S_full", [
    (128, 0, 256, 256), (512, 0, 1024, 1024), (128, 1000, 2048, 2560),
    (512, 1000, 2048, 2560), (192, 128, 320, 448)],
    ids=["T128", "T512", "T128-deep", "T512-deep", "T192-odd"])
def test_flash_attention_kernel_alibi(cuda, monkeypatch, heads, T, n_past, S, S_full):
    """Kernel C with ALiBi (alibi_max_bias 8: BLOOM's slopes by query head)
    against the masked softmax with the same slopes, over the T/S edges of
    the cases above, at GQA groups of 1, 8 and 48 (StarCoder's multi-query
    attention): NMSE < 1e-4 over rows with a visible key, rows with none
    exactly 0, two calls bit-identical. The term is one exact FMA: with
    slopes of 0 the kernel gives its bits without slopes."""
    H, Hkv = heads
    q, k, v, qs, kvp, pos, vf = _attn_inputs(cuda, H, Hkv, T, S, S_full, (0, 37, 100), n_past)
    bare_cfg = ModelConfig(n_head=H, n_head_kv=Hkv, head_dim=128, head_dim_v=128)
    cfg = dataclasses.replace(bare_cfg, use_rope=False, alibi_max_bias=8.0)
    before = _cuda.COUNTS["flash_attention"]
    got = flash_attention(q, k, v, qs, kvp, pos, vf, cfg)
    again = flash_attention(q, k, v, qs, kvp, pos, vf, cfg)
    want = masked_attention(q, k, v, qs, kvp, pos, vf, 1.0 / 128 ** 0.5,
                            slopes=alibi_of(cfg, cuda))
    bare = flash_attention(q, k, v, qs, kvp, pos, vf, bare_cfg)
    monkeypatch.setattr(fa, "alibi_of", lambda c, dev: torch.zeros(H, device=dev))
    zero = flash_attention(q, k, v, qs, kvp, pos, vf, bare_cfg)
    torch.cuda.synchronize()
    assert _cuda.COUNTS["flash_attention"] == before + 4
    assert torch.equal(got, again) and torch.equal(zero, bare)
    for b, f in enumerate(vf.tolist()):
        live = qs[b] >= f
        assert torch.count_nonzero(got[b, ~live]) == 0
        assert torch.count_nonzero(want[b, ~live]) == 0
        assert _nmse(got[b, live], want[b, live]) < 1e-4
    assert _nmse(bare[0], got[0]) > 1e-3  # the bias moves the output


def _layer_setup(cuda, qtype, L=3, D=512, n_ff=1024):
    g = torch.Generator(device=cuda).manual_seed(int(qtype))
    H, Hkv, hd = 4, 2, 128
    cfg = ModelConfig(n_embd=D, n_layer=L, n_head=H, n_head_kv=Hkv, head_dim=hd,
                      head_dim_v=hd, n_ff=n_ff)
    qw = {"wo": random_kmajor(qtype, [D], H * hd, (L,), g, cuda),
          "ffn_gateup": random_kmajor(qtype, [n_ff, n_ff], D, (L,), g, cuda),
          "ffn_down": random_kmajor(qtype, [D], n_ff, (L,), g, cuda),
          "wqkv": random_kmajor(qtype, [H * hd, Hkv * hd, Hkv * hd], D, (L,), g, cuda)}
    norms = 1 + 0.1 * torch.randn((2, L, D), generator=g, device=cuda)
    return cfg, qw, norms, g


@pytest.mark.parametrize("qtype,act", [(GGMLType.Q4_K, "silu"), (GGMLType.Q6_K, "silu"),
                                       (GGMLType.Q4_K, "gelu"), (GGMLType.Q4_K, "swiglu_oai")])
@pytest.mark.parametrize("M", [1, 4, 16])
def test_layer_kernel_vs_plain(cuda, qtype, act, M):
    """Kernel D, plain and folded, vs the plain composition. The kernel
    rounds weights to bf16, the plain version keeps them f32: NMSE < 1e-4
    on the layer output and on the next layer's qkv."""
    cfg, qw, norms, g = _layer_setup(cuda, qtype)
    cfg.act_fn = act
    att = (0.5 * torch.randn((M, 1, 512), generator=g, device=cuda)).to(torch.bfloat16)
    x = torch.randn((M, 1, 512), generator=g, device=cuda).to(torch.bfloat16)
    for layer in (0, 2):
        out = ffn_block(att, x, norms[0, layer], qw, layer, cfg)
        want = layer_plain(att, x, norms[0, layer], qw, layer, cfg)
        out_f, qkv = ffn_block_qkv(att, x, norms[0, layer], norms[1], qw, layer, cfg)
        want_f, want_qkv = layer_plain(att, x, norms[0, layer], qw, layer, cfg, norms[1])
        torch.cuda.synchronize()
        assert out.shape == want.shape == (M, 1, 512)
        assert _nmse(out, want) < 1e-4
        assert torch.equal(out, out_f)
        assert _nmse(out_f, want_f) < 1e-4
        assert qkv.shape == want_qkv.shape == (M, 1, qw["wqkv"].data["q"].shape[-1])
        assert _nmse(qkv, want_qkv) < 1e-4


def test_layer_kernel_mixed_types(cuda):
    """Pools of different kinds in one layer (as in Q4_K_M-style files):
    wo Q8_0, gate/up Q5_K, down Q6_K, next QKV Q4_0."""
    cfg, qw, norms, g = _layer_setup(cuda, GGMLType.Q4_K)
    L, D, Hd, n_ff = 3, 512, 512, 1024
    qw = {"wo": random_kmajor(GGMLType.Q8_0, [D], Hd, (L,), g, cuda),
          "ffn_gateup": random_kmajor(GGMLType.Q5_K, [n_ff, n_ff], D, (L,), g, cuda),
          "ffn_down": random_kmajor(GGMLType.Q6_K, [D], n_ff, (L,), g, cuda),
          "wqkv": random_kmajor(GGMLType.Q4_0, [512, 256, 256], D, (L,), g, cuda)}
    att = (0.5 * torch.randn((4, 1, Hd), generator=g, device=cuda)).to(torch.bfloat16)
    x = torch.randn((4, 1, D), generator=g, device=cuda).to(torch.bfloat16)
    out, qkv = ffn_block_qkv(att, x, norms[0, 1], norms[1], qw, 1, cfg)
    want, want_qkv = layer_plain(att, x, norms[0, 1], qw, 1, cfg, norms[1])
    torch.cuda.synchronize()
    assert _nmse(out, want) < 1e-4 and _nmse(qkv, want_qkv) < 1e-4


def _check_layer(qw, cfg, norms, g, M, layer, tol=1e-4):
    """Kernel D, plain and folded, at one layer of qw against the plain
    composition: NMSE < tol on the output and the next layer's qkv, the
    plain and folded outputs equal, two calls bit-identical."""
    Hd = qw["wo"].shape[-1]
    D = cfg.n_embd
    att = (0.5 * torch.randn((M, 1, Hd), generator=g, device="cuda")).to(torch.bfloat16)
    x = torch.randn((M, 1, D), generator=g, device="cuda").to(torch.bfloat16)
    out = ffn_block(att, x, norms[0, layer], qw, layer, cfg)
    out_f, qkv = ffn_block_qkv(att, x, norms[0, layer], norms[1], qw, layer, cfg)
    out_f2, qkv2 = ffn_block_qkv(att, x, norms[0, layer], norms[1], qw, layer, cfg)
    want = layer_plain(att, x, norms[0, layer], qw, layer, cfg)
    want_f, want_qkv = layer_plain(att, x, norms[0, layer], qw, layer, cfg, norms[1])
    torch.cuda.synchronize()
    assert torch.equal(out, out_f) and torch.equal(out_f, out_f2) and torch.equal(qkv, qkv2)
    assert _nmse(out, want) < tol and _nmse(out_f, want_f) < tol
    assert qkv.shape == want_qkv.shape and _nmse(qkv, want_qkv) < tol


# (D, heads, kv heads, n_ff): Llama-3-8B, Llama-2-7B, Llama-2-13B
_WIDTHS = {"8B": (4096, 32, 8, 14336), "7B": (4096, 32, 32, 11008),
           "13B": (5120, 40, 40, 13824)}


@pytest.mark.parametrize("width,M", [("8B", 1), ("8B", 4), ("8B", 16), ("7B", 4),
                                     ("13B", 4)])
def test_layer_kernel_full_width(cuda, width, M):
    """Kernel D at published widths, Q4_K, plain and folded: the 8B slab
    plan and the two Llama-2 ones, whose slab counts differ from the 8B
    plan (uneven splits of the down pool's K)."""
    D, H, Hkv, n_ff = _WIDTHS[width]
    L, hd = 2, 128
    g = torch.Generator(device=cuda).manual_seed(D + n_ff + M)
    cfg = ModelConfig(n_embd=D, n_layer=L, n_head=H, n_head_kv=Hkv, head_dim=hd,
                      head_dim_v=hd, n_ff=n_ff)
    q = GGMLType.Q4_K
    qw = {"wo": random_kmajor(q, [D], H * hd, (L,), g, cuda),
          "ffn_gateup": random_kmajor(q, [n_ff, n_ff], D, (L,), g, cuda),
          "ffn_down": random_kmajor(q, [D], n_ff, (L,), g, cuda),
          "wqkv": random_kmajor(q, [H * hd, Hkv * hd, Hkv * hd], D, (L,), g, cuda)}
    norms = 1 + 0.1 * torch.randn((2, L, D), generator=g, device=cuda)
    _check_layer(qw, cfg, norms, g, M, 0)


@pytest.mark.parametrize("qtype", sorted(KM_SPECS, key=lambda t: t.name))
def test_layer_kernel_all_types(cuda, qtype):
    """Kernel D with every K-major type in all four pools (512 widths, M =
    4, folded and plain), through each of the slab body's kind and dequant
    modes."""
    cfg, _, norms, g = _layer_setup(cuda, GGMLType.Q4_K)
    L, D, Hd, n_ff = 3, 512, 512, 1024
    qw = {"wo": random_kmajor(qtype, [D], Hd, (L,), g, cuda),
          "ffn_gateup": random_kmajor(qtype, [n_ff, n_ff], D, (L,), g, cuda),
          "ffn_down": random_kmajor(qtype, [D], n_ff, (L,), g, cuda),
          "wqkv": random_kmajor(qtype, [512, 256, 256], D, (L,), g, cuda)}
    _check_layer(qw, cfg, norms, g, 4, 1)


def test_kernels_deterministic(cuda):
    """No atomics: two identical calls give identical bits."""
    cfg, qw, norms, g = _layer_setup(cuda, GGMLType.Q4_K)
    att = torch.randn((4, 1, 512), generator=g, device=cuda).to(torch.bfloat16)
    x = torch.randn((4, 1, 512), generator=g, device=cuda).to(torch.bfloat16)
    a = ffn_block_qkv(att, x, norms[0, 1], norms[1], qw, 1, cfg)
    b = ffn_block_qkv(att, x, norms[0, 1], norms[1], qw, 1, cfg)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    w = qw["wqkv"]
    y1 = qmm_kmajor(x.reshape(4, 512), w.data, w.qtype, w.n_out, torch.float32, 0)
    y2 = qmm_kmajor(x.reshape(4, 512), w.data, w.qtype, w.n_out, torch.float32, 0)
    assert torch.equal(y1, y2)
    # kernel A at its largest padded M, bf16 out, on each dequant mode
    for qtype in (GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.IQ4_NL):
        qt = random_kmajor(qtype, [300, 200], 1024, (), g, cuda)
        x32 = torch.randn((32, 1024), generator=g, device=cuda).to(torch.bfloat16)
        y1 = qmm_kmajor(x32, qt.data, qtype, qt.n_out, torch.bfloat16)
        y2 = qmm_kmajor(x32, qt.data, qtype, qt.n_out, torch.bfloat16)
        assert torch.equal(y1, y2), qtype


def test_engine_on_card_matches_cpu(cuda):
    """The slice end to end at a small width: the card's bf16 path through
    the dense path's four kernels (A-D; F is the MoE path's) against the plain path on the CPU in f32. Tolerance:
    4x the NMSE of the same plain path run in bf16 on the CPU (the error
    bf16 arithmetic alone brings); the same first greedy token on every
    row whose top two f32 logits are more than 0.05 apart."""
    import numpy as np

    from tpullm_torch.runtime.engine import InferenceEngine
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    cfg, params = synth_kmajor_q4k_fast(vocab_size=512, n_embd=512, n_layer=2, n_head=4,
                                        n_head_kv=2, n_ff=1024, seed=3, centred=True,
                                        device="cpu")
    card = {k: (v.to("cuda") if not isinstance(v, dict) else
                {n: t.to("cuda") for n, t in v.items()}) for k, v in params.items()}
    prompts = [list(range(1, 101)), list(range(7, 67)), list(range(40, 70))]
    logits = {}
    for name, p, dev, dt in (("card", card, "cuda", torch.bfloat16),
                             ("cpu", params, "cpu", torch.float32),
                             ("cpu_bf16", params, "cpu", torch.bfloat16)):
        if dev == "cuda":
            _cuda.reset_counts()
        eng = InferenceEngine(cfg, p, max_seq_len=256, compute_dtype=dt, decode_chunk=4,
                              device=dev)
        r = eng.generate(prompts, max_new_tokens=5, return_logits=True)
        if dev == "cuda":
            counts = dict(_cuda.COUNTS)
        logits[name] = (torch.from_numpy(np.asarray(r.logits)), r.tokens)
    assert all(counts[k] > 0 for k in ("qmm_splitk", "qmm", "flash_attention",
                                       "layer_kernel")), counts
    assert counts["moe_gmm"] == 0, counts
    ref = _nmse(logits["cpu_bf16"][0], logits["cpu"][0])
    assert _nmse(logits["card"][0], logits["cpu"][0]) < 4 * ref
    top2 = torch.topk(logits["cpu"][0], 2, dim=-1).values
    for b, gap in enumerate((top2[:, 0] - top2[:, 1]).tolist()):
        if gap > 0.05:
            assert logits["card"][1][b][0] == logits["cpu"][1][b][0]


@pytest.mark.parametrize("flag", [None, "1"])
def test_engine_head_dim_256_on_card_matches_cpu(cuda, monkeypatch, flag):
    """A Llama-family model with head dim 256 (n_embd 1024, 4/2 heads) runs
    on the card: its prefill (prompts bucketed to 128 tokens) takes kernel
    C's head-dim-256 instance, and decode takes kernel E when
    TPULLM_FLASH_DECODE is set. Held to
    test_engine_on_card_matches_cpu's rule: 4x the NMSE of the plain path
    in bf16 against the plain path in f32, and the same first greedy token
    on every row whose top two f32 logits are more than 0.05 apart."""
    import numpy as np

    from tpullm_torch.runtime.engine import InferenceEngine
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    if flag:
        monkeypatch.setenv("TPULLM_FLASH_DECODE", flag)
    else:
        monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
    cfg, params = synth_kmajor_q4k_fast(vocab_size=512, n_embd=1024, n_layer=2, n_head=4,
                                        n_head_kv=2, n_ff=1024, seed=3, centred=True,
                                        device="cpu")
    assert cfg.head_dim == 256
    card = {k: (v.to("cuda") if not isinstance(v, dict) else
                {n: t.to("cuda") for n, t in v.items()}) for k, v in params.items()}
    prompts = [list(range(1, 101)), list(range(7, 67)), list(range(40, 70))]
    logits = {}
    for name, p, dev, dt in (("card", card, "cuda", torch.bfloat16),
                             ("cpu", params, "cpu", torch.float32),
                             ("cpu_bf16", params, "cpu", torch.bfloat16)):
        if dev == "cuda":
            _cuda.reset_counts()
        eng = InferenceEngine(cfg, p, max_seq_len=256, compute_dtype=dt, decode_chunk=4,
                              device=dev)
        r = eng.generate(prompts, max_new_tokens=5, return_logits=True)
        if dev == "cuda":
            counts = dict(_cuda.COUNTS)
        logits[name] = (torch.from_numpy(np.asarray(r.logits)), r.tokens)
    assert counts["flash_attention"] > 0, counts
    assert (counts["flash_decode"] > 0) == bool(flag), counts
    assert counts["qmm"] > 0 and counts["layer_kernel"] > 0, counts
    ref = _nmse(logits["cpu_bf16"][0], logits["cpu"][0])
    assert _nmse(logits["card"][0], logits["cpu"][0]) < 4 * ref
    top2 = torch.topk(logits["cpu"][0], 2, dim=-1).values
    for b, gap in enumerate((top2[:, 0] - top2[:, 1]).tolist()):
        if gap > 0.05:
            assert logits["card"][1][b][0] == logits["cpu"][1][b][0]


@pytest.mark.parametrize("flag", [None, "1"])
@pytest.mark.parametrize("arch", ["qwen3", "qwen2"])
def test_engine_arch_flags_on_card_matches_cpu(cuda, monkeypatch, arch, flag):
    """The dense decoder's flags on the card: a 2-layer qwen3 synth (per-head
    QK norms; n_embd 512, 4/2 heads) and a 2-layer qwen2 synth (q/k/v
    biases; n_embd 1792, 14/2 heads of 128, so a GQA group of 7 as
    Qwen2.5-7B's), each with a 500-row vocab over 512-row padded arrays
    (logits 500 wide). Through the engine on the card against the plain
    path on the CPU in f32, with test_engine_on_card_matches_cpu's rule;
    qwen3 decodes on kernel D, qwen2 on A's unfused path (no D), both
    prefill on C; then the same requests with cuda_graphs=False give the
    graph's greedy tokens and launch counts."""
    import numpy as np

    from tpullm_torch.runtime.engine import InferenceEngine
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    if flag:
        monkeypatch.setenv("TPULLM_FLASH_DECODE", flag)
    else:
        monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
    width = dict(n_embd=512, n_head=4, n_head_kv=2) if arch == "qwen3" else dict(
        n_embd=1792, n_head=14, n_head_kv=2)
    cfg, params = synth_kmajor_q4k_fast(vocab_size=500, n_layer=2, n_ff=1024, seed=3,
                                        centred=True, device="cpu", arch=arch, rope_base=1e6,
                                        rms_eps=1e-6, exact_vocab=True, **width)
    card = {k: (v.to("cuda") if not isinstance(v, dict) else
                {n: t.to("cuda") for n, t in v.items()}) for k, v in params.items()}
    prompts = [list(range(1, 101)), list(range(7, 67)), list(range(40, 70))]
    logits, counts = {}, {}
    for name, p, dev, dt in (("card", card, "cuda", torch.bfloat16),
                             ("card_eager", card, "cuda", torch.bfloat16),
                             ("cpu", params, "cpu", torch.float32),
                             ("cpu_bf16", params, "cpu", torch.bfloat16)):
        _cuda.reset_counts()
        eng = InferenceEngine(cfg, p, max_seq_len=256, compute_dtype=dt, decode_chunk=4,
                              device=dev, cuda_graphs=name != "card_eager")
        r = eng.generate(prompts, max_new_tokens=9, return_logits=True)
        counts[name] = dict(_cuda.COUNTS)
        logits[name] = (torch.from_numpy(np.asarray(r.logits)), r.tokens)
    c = counts["card"]
    assert logits["card"][0].shape[-1] == 500
    assert all(0 <= t < 500 for row in logits["card"][1] for t in row)
    assert c["qmm_splitk"] > 0 and c["qmm"] > 0 and c["flash_attention"] > 0, c
    assert (c["layer_kernel"] > 0) == (arch == "qwen3"), c
    assert (c["flash_decode"] > 0) == bool(flag), c
    assert logits["card_eager"][1] == logits["card"][1] and counts["card_eager"] == c
    ref = _nmse(logits["cpu_bf16"][0], logits["cpu"][0])
    assert _nmse(logits["card"][0], logits["cpu"][0]) < 4 * ref
    top2 = torch.topk(logits["cpu"][0], 2, dim=-1).values
    for b, gap in enumerate((top2[:, 0] - top2[:, 1]).tolist()):
        if gap > 0.05:
            assert logits["card"][1][b][0] == logits["cpu"][1][b][0]


def _ragged(cuda, g, routing, E, M=150, K=2048, used=2, tm=256):
    """Expert-sorted rows for a routing: random, all to one expert
    (skewed), or with experts 0 and E-1 never chosen (empty), on row tiles
    of tm."""
    if routing == "random":
        top_i = torch.rand((M, E), generator=g, device=cuda).argsort(-1)[:, :used]
    elif routing == "skewed":
        top_i = torch.full((M, used), 1, device=cuda)
    else:
        top_i = torch.randint(1, E - 1, (M, used), generator=g, device=cuda)
    order, dest, te, Mp = sort_by_expert(top_i, E, M, tm)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    xs = torch.zeros((Mp, K), dtype=torch.bfloat16, device=cuda)
    xs[dest] = x[order // used]
    return xs, te, live_tiles(dest, te, Mp)


@pytest.mark.parametrize("qtype", sorted(KM_SPECS, key=lambda t: t.name))
@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("M,nout", [(150, 300), (600, 300), (600, 299)])
def test_moe_gmm_kernel_vs_plain(cuda, qtype, layered, M, nout):
    """Kernel F vs its plain version (same bf16 weights, f32 sums in another
    order: NMSE < 1e-5) for random, skewed and empty-expert routings, with
    and without the live-tile count; two calls give identical bits. K is
    2048, the smallest K tile every type takes (TQ2_0's). M = 600 tokens
    (1200 assignments over 4 experts) puts expert counts across 256-row
    tile boundaries; an odd Nout (299 of 384 columns) takes the epilogue's
    and the dead tiles' unpaired stores."""
    g = torch.Generator(device=cuda).manual_seed(int(qtype) + M)
    E = 4
    qt = random_kmajor(qtype, [300], 2048, (3, E) if layered else (E,), g, cuda)
    layer = 2 if layered else None
    for routing in ("random", "skewed", "empty"):
        xs, te, live = _ragged(cuda, g, routing, E, M=M)
        want = grouped_qmm_plain(xs, te, qt, nout, layer)
        for lv in (None, live):
            before = _cuda.COUNTS["moe_gmm"]
            y1 = grouped_qmm(xs, te, qt, nout, layer, lv)
            y2 = grouped_qmm(xs, te, qt, nout, layer, lv)
            torch.cuda.synchronize()
            assert _cuda.COUNTS["moe_gmm"] == before + 2
            assert y1.shape == want.shape == (xs.shape[0], nout)
            assert torch.equal(y1, y2)
            assert _nmse(y1, want) < 1e-5, (routing, lv is not None)


def test_moe_gmm_refuses_other_tile(cuda):
    """Kernel F takes 256-row tiles only: the JAX package's 128-row
    bookkeeping raises on the card (no fallback), whether its row count is
    a multiple of 256 or not."""
    g = torch.Generator(device=cuda).manual_seed(5)
    qt = random_kmajor(GGMLType.Q4_K, [300], 2048, (4,), g, cuda)
    for M in (150, 128):  # Mp 896 and 768 at 128-row tiles
        xs, te, live = _ragged(cuda, g, "random", 4, M=M, tm=128)
        with pytest.raises(ValueError, match="256-row tiles"):
            grouped_qmm(xs, te, qt, 300, None, live)


def test_moe_gmm_unsupported_raises(cuda):
    """On the card there is no fallback: a weight kernel F does not take
    raises (here Q4_K at K=256, under its K tile, and a dense weight)."""
    from tpullm_torch.ops.qtensor import QTensor

    g = torch.Generator(device=cuda).manual_seed(0)
    te = torch.zeros(2, dtype=torch.int32, device=cuda)
    short = random_kmajor(GGMLType.Q4_K, [256], 256, (2,), g, cuda)
    with pytest.raises(NotImplementedError, match="kernel F"):
        grouped_qmm(torch.zeros((256, 256), dtype=torch.bfloat16, device=cuda), te, short, 256)
    dense = QTensor(GGMLType.F32, (2, 256, 1024),
                    {"w": torch.zeros((2, 256, 1024), device=cuda)})
    with pytest.raises(NotImplementedError, match="kernel F"):
        grouped_qmm(torch.zeros((256, 1024), dtype=torch.bfloat16, device=cuda), te, dense, 256)


def test_moe_engine_on_card_matches_cpu(cuda):
    """The MoE slice at a small width: prefill through kernels B, C and F,
    decode through A and its expert-skip variant, no D; the card's bf16
    logits within 4x the NMSE of the CPU's bf16 plain path against its f32
    one."""
    import numpy as np

    from tpullm_torch.runtime.engine import InferenceEngine
    from tpullm_torch.utils.synth import synth_mixtral_q4k

    cfg, params = synth_mixtral_q4k(vocab_size=512, n_embd=512, n_layer=2, n_head=4,
                                    n_head_kv=2, n_ff=1024, n_expert=4, n_expert_used=2,
                                    seed=3, device="cpu")
    card = {k: (v.to("cuda") if not isinstance(v, dict) else
                {n: t.to("cuda") for n, t in v.items()}) for k, v in params.items()}
    prompts = [list(range(1, 101)), list(range(7, 67)), list(range(40, 70))]
    logits = {}
    for name, p, dev, dt in (("card", card, "cuda", torch.bfloat16),
                             ("cpu", params, "cpu", torch.float32),
                             ("cpu_bf16", params, "cpu", torch.bfloat16)):
        if dev == "cuda":
            _cuda.reset_counts()
        eng = InferenceEngine(cfg, p, max_seq_len=256, compute_dtype=dt, decode_chunk=4,
                              device=dev)
        r = eng.generate(prompts, max_new_tokens=5, return_logits=True)
        if dev == "cuda":
            counts = dict(_cuda.COUNTS)
        logits[name] = torch.from_numpy(np.asarray(r.logits))
    assert counts["layer_kernel"] == 0, counts
    assert all(counts[k] > 0 for k in ("qmm_splitk", "qmm", "flash_attention", "moe_gmm",
                                       "qmm_experts"))
    ref = _nmse(logits["cpu_bf16"], logits["cpu"])
    assert _nmse(logits["card"], logits["cpu"]) < 4 * ref


# ------------------------------------------------------------ the expert skip

def _routing(cuda, g, kind, M, E, used):
    """top_i (M, used) and its renormalized weights: random picks, every row
    the same experts, or one expert in every row's first pick."""
    if kind == "same":
        top_i = torch.arange(used, device=cuda).repeat(M, 1) * 3 % E
    else:
        top_i = torch.rand((M, E), generator=g, device=cuda).argsort(-1)[:, :used]
        if kind == "one":
            top_i[:, 0] = E - 1
            top_i[:, 1:] = torch.where(top_i[:, 1:] == E - 1, 0, top_i[:, 1:])
    w = torch.rand((M, used), generator=g, device=cuda) + 0.1
    return top_i, w / w.sum(-1, keepdim=True)


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0])
@pytest.mark.parametrize("M,E,used,routing", [
    (1, 16, 2, "random"), (4, 16, 2, "random"), (4, 16, 2, "same"), (7, 16, 2, "one"),
    (9, 16, 2, "random"), (16, 16, 2, "random"), (16, 8, 2, "one"), (4, 64, 8, "random"),
    (16, 64, 8, "random")])
def test_qmm_experts_vs_expert_loop(cuda, qtype, M, E, used, routing):
    """Kernel A's expert-skip variant on layer 1 of a 2-layer (L, E) stack
    (capacity min(E, M * used): below E and at it) against A called on each
    listed expert: every slot's product bit for bit (A's split plan and
    reduce order), padded slots 0; the down projection's combining pass bit
    for bit against the loop's ``out + de * we`` in expert order; both
    against the plain version (NMSE < 1e-5); one launch a call."""
    from tpullm_torch.models.llama import expert_weight
    from tpullm_torch.ops.moe_decode import (expert_slots, experts_combine,
                                             experts_combine_plain, qmm_experts,
                                             qmm_experts_plain)

    g = torch.Generator(device=cuda).manual_seed(M * 100 + E)
    K, N = 1024, 512  # down's K = N: Q4_K's K tiles start at 512
    up = random_kmajor(qtype, [N], K, (2, E), g, cuda)
    down = random_kmajor(qtype, [K], N, (2, E), g, cuda)
    top_i, w = _routing(cuda, g, routing, M, E, used)
    ids = expert_slots(top_i, E)
    assert ids.shape == (min(E, M * used),)
    listed = [e for e in ids.tolist() if e >= 0]
    assert listed == sorted(set(top_i.reshape(-1).tolist()))
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    before = _cuda.COUNTS["qmm_experts"]
    u = qmm_experts(x, up, 1, ids)
    assert _cuda.COUNTS["qmm_experts"] == before + 1
    for slot in range(ids.shape[0]):
        if slot < len(listed):
            e = listed[slot]
            want = qmm_kmajor(x, expert_weight(up, 1, e).data, qtype, N, torch.bfloat16)
            assert torch.equal(u[slot], want), (slot, e)
        else:
            assert not u[slot].any()
    assert _nmse(u, qmm_experts_plain(x, up, 1, ids)) < 1e-5
    h = torch.randn((ids.shape[0], M, N), generator=g, device=cuda).to(torch.bfloat16)
    out = experts_combine(h, down, 1, ids, top_i, w)
    loop = torch.zeros((M, K), dtype=torch.bfloat16, device=cuda)
    for slot, e in enumerate(listed):
        de = qmm_kmajor(h[slot], expert_weight(down, 1, e).data, qtype, K, torch.bfloat16)
        loop = loop + de * (w * (top_i == e)).sum(-1)[:, None].to(torch.bfloat16)
    assert torch.equal(out, loop)
    assert _nmse(out, experts_combine_plain(h, down, 1, ids, top_i, w)) < 1e-5
    f32 = experts_combine(h, down, 1, ids, top_i, w, torch.float32)
    assert f32.dtype == torch.float32
    assert _nmse(f32, experts_combine_plain(h, down, 1, ids, top_i, w, torch.float32)) < 1e-5


@pytest.mark.parametrize("qtype", sorted(KM_SPECS, key=lambda t: t.name))
def test_qmm_experts_all_types(cuda, qtype):
    """Every K-major type through the skip kernel and its combine on an
    (E,) stack (N 1024, K 2048: TQ2_0's K tiles start at 2048), M = 4,
    top-2 of 8, against the plain version (NMSE < 1e-5)."""
    from tpullm_torch.ops.moe_decode import (expert_slots, experts_combine,
                                             experts_combine_plain, qmm_experts,
                                             qmm_experts_plain)

    g = torch.Generator(device=cuda).manual_seed(5)
    E, M, K = 8, 4, 2048
    qt = random_kmajor(qtype, [1024], K, (E,), g, cuda)
    top_i, w = _routing(cuda, g, "random", M, E, 2)
    ids = expert_slots(top_i, E)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    assert _nmse(qmm_experts(x, qt, None, ids), qmm_experts_plain(x, qt, None, ids)) < 1e-5
    h = torch.randn((ids.shape[0], M, K), generator=g, device=cuda).to(torch.bfloat16)
    assert _nmse(experts_combine(h, qt, None, ids, top_i, w),
                 experts_combine_plain(h, qt, None, ids, top_i, w)) < 1e-5


def test_qmm_experts_builds_without_spills(cuda):
    """The skip variant's instances keep A's registers: no spill bytes."""
    info = _cuda.build()
    b = [(n, spill) for n, _, spill in info["ptxas"] if "qmm_experts_kernel" in n]
    assert info["cached"] or (b and all(spill == 0 for _, spill in b)), b


def test_qmm_experts_refuses(cuda):
    """A planar stack, a single weight, more than 16 rows, int64 slots and
    more slots than the combine holds (MAX_SLOTS) raise; the route sends the
    planar stack, B*T > 16 and min(E, B*T * used) > MAX_SLOTS elsewhere, and
    gates on that slot count, not on E: a stack of more than MAX_SLOTS
    experts takes the skip at decode, equal to A on each listed expert."""
    from tpullm_torch.models.llama import expert_weight, moe_route
    from tpullm_torch.ops.moe_decode import MAX_SLOTS, expert_slots, qmm_experts
    from tpullm_torch.ops.qmm import qmm_kmajor
    from tpullm_torch.ops.qtensor import QTensor

    g = torch.Generator(device=cuda).manual_seed(1)
    qt = random_kmajor(GGMLType.Q4_K, [512], 512, (4,), g, cuda)
    top_i = torch.tensor([[0, 2]], device=cuda)
    ids = expert_slots(top_i, 4)
    with pytest.raises(ValueError):
        qmm_experts(torch.zeros((17, 512), device=cuda), qt, None, expert_slots(
            torch.zeros((17, 2), dtype=torch.int64, device=cuda), 4))
    with pytest.raises(ValueError):
        qmm_experts(torch.zeros((1, 512), device=cuda), qt, None, ids.long())
    flat = random_kmajor(GGMLType.Q4_K, [512], 512, (), g, cuda)
    with pytest.raises(NotImplementedError):
        qmm_experts(torch.zeros((1, 512), device=cuda), flat, None, ids)
    planar = QTensor(GGMLType.Q8_0, (4, 512, 512), {"d": torch.zeros((4, 512, 16), device=cuda),
                                                    "qs": torch.zeros((4, 512, 16, 32),
                                                                      device=cuda)})
    assert moe_route(True, 4, qt, qt, qt, 512, 2) == "skip"
    assert moe_route(True, 4, qt, qt, planar, 512, 2) == "loop"
    assert moe_route(True, 64, qt, qt, qt, 512, 2) == "ragged"
    E = MAX_SLOTS + 16
    big = random_kmajor(GGMLType.Q4_K, [512], 512, (E,), g, cuda)  # gate, up and down
    assert moe_route(True, 16, big, big, big, 512, 8) == "skip"  # 128 slots
    assert moe_route(True, 16, big, big, big, 512, MAX_SLOTS // 16 + 1) == "loop"
    with pytest.raises(NotImplementedError):
        qmm_experts(torch.zeros((16, 512), device=cuda), big, None,
                    torch.arange(MAX_SLOTS + 1, dtype=torch.int32, device=cuda))
    top_i = torch.rand((16, E), generator=g, device=cuda).argsort(-1)[:, :8]
    ids = expert_slots(top_i, E)
    x = torch.randn((16, 512), generator=g, device=cuda).to(torch.bfloat16)
    got = qmm_experts(x, big, None, ids)
    for slot, e in enumerate(ids.tolist()):
        if e >= 0:
            want = qmm_kmajor(x, expert_weight(big, None, e).data, big.qtype, 512, torch.bfloat16)
            assert torch.equal(got[slot], want), (slot, e)


def _moe_card(arch, **kw):
    from tpullm_torch.utils.synth import synth_moe_q4k

    base = dict(vocab_size=500, n_embd=512, n_layer=2, n_head=4, n_head_kv=2, n_ff=1024,
                n_expert=16, n_expert_used=4, n_ff_exp=512, rms_eps=1e-6, exact_vocab=True,
                seed=3, device="cpu")
    if arch == "qwen3moe":  # 8 heads of 128: q 1024 wide over the 512-wide stream
        base.update(n_head=8, head_dim=128, down_qtype=GGMLType.Q6_K)
    elif arch == "ernie4_5-moe":  # a dense lead, the selection bias, an ungated shared expert
        base.update(n_layer=3, n_ff_shexp=1024, n_dense_lead=1, probs_b_std=0.05,
                    shexp_gate=False, tied=True, cfg_fields=dict(expert_weights_norm=True))
    else:
        base.update(n_ff_shexp=1024)
    base.update(kw)
    return synth_moe_q4k(arch=arch, **base)


def _to(v, dev):
    """params (QTensors, tensors, dicts and the layer groups' list) on dev."""
    if isinstance(v, dict):
        return {k: _to(x, dev) for k, x in v.items()}
    if isinstance(v, list):
        return [_to(x, dev) for x in v]
    return v.to(dev)


@pytest.mark.parametrize("arch", ["qwen3moe", "qwen2moe", "ernie4_5-moe"])
def test_qwen_moe_engine_on_card_matches_cpu(cuda, monkeypatch, arch):
    """qwen3moe (per-head QK norms, renormalized top-4 of 16, q 1024 wide
    over a 512-wide stream, Q6_K down experts), qwen2moe (biases, a shared
    expert with its sigmoid gate) and ernie4_5-moe (a dense first layer,
    the router's selection bias inside the captured step, an ungated shared
    expert, a tied lm_head): the engine on the card against the plain
    path on the CPU (test_engine_on_card_matches_cpu's rule), prefill
    through F and decode through the skip kernel; the same requests with
    cuda_graphs=False give the graph's tokens and launch counts."""
    import numpy as np

    from tpullm_torch.runtime.engine import InferenceEngine

    monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
    cfg, params = _moe_card(arch)
    card = _to(params, "cuda")
    if cfg.tie_embeddings:
        card["output"] = card["tok_embd"]
    logits, counts = {}, {}
    for name, p, dev, dt in (("card", card, "cuda", torch.bfloat16),
                             ("card_eager", card, "cuda", torch.bfloat16),
                             ("cpu", params, "cpu", torch.float32),
                             ("cpu_bf16", params, "cpu", torch.bfloat16)):
        _cuda.reset_counts()
        eng = InferenceEngine(cfg, p, max_seq_len=256, compute_dtype=dt, decode_chunk=4,
                              device=dev, cuda_graphs=name != "card_eager")
        r = eng.generate(ENGINE_PROMPTS, max_new_tokens=9, return_logits=True)
        counts[name] = dict(_cuda.COUNTS)
        logits[name] = (torch.from_numpy(np.asarray(r.logits)), r.tokens)
    c = counts["card"]
    assert all(c[k] > 0 for k in ("qmm_splitk", "qmm", "flash_attention", "moe_gmm",
                                  "qmm_experts")), c
    assert c["layer_kernel"] == 0, c
    assert logits["card_eager"][1] == logits["card"][1] and counts["card_eager"] == c
    ref = _nmse(logits["cpu_bf16"][0], logits["cpu"][0])
    assert _nmse(logits["card"][0], logits["cpu"][0]) < 4 * ref


def test_biased_moe_synth_on_card_reads_bias_in_place(cuda, monkeypatch):
    """synth_moe_q4k drawn on the card with a dense first layer, the
    selection bias and an ungated shared expert: two groups (the dense
    lead's fused gate/up, the MoE layers' bias), and the engine runs it
    (F and the skip launched, D not: the dense lead stays off it with the
    MoE rows). The captured decode step reads the bias where it lies: with
    the bias zeroed in place, the same graph's replays give the eager
    engine's tokens for the zeroed bias, which differ from the biased ones;
    restored, the first tokens again."""
    from tpullm_torch.runtime.engine import InferenceEngine

    monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
    cfg, params = _moe_card("ernie4_5-moe", device="cuda")
    dense, moe = params["layers"]["__groups__"]
    assert dense["ffn_gateup"].shape[0] == 1 and "moe_gate_inp_shexp" not in moe
    bias = moe["moe_probs_b"]
    assert bias.is_cuda and bias.shape == (2, 16)
    eng = InferenceEngine(cfg, params, max_seq_len=256, decode_chunk=8)
    eager = InferenceEngine(cfg, params, max_seq_len=256, decode_chunk=8, cuda_graphs=False)
    _cuda.reset_counts()
    first = eng.generate(ENGINE_PROMPTS, max_new_tokens=33)
    c = dict(_cuda.COUNTS)
    assert c["moe_gmm"] > 0 and c["qmm_experts"] > 0 and c["layer_kernel"] == 0, c
    assert eager.generate(ENGINE_PROMPTS, max_new_tokens=33).tokens == first.tokens
    saved = bias.clone()
    bias.zero_()
    free = eng.generate(ENGINE_PROMPTS, max_new_tokens=33)
    assert free.tokens == eager.generate(ENGINE_PROMPTS, max_new_tokens=33).tokens
    assert free.tokens != first.tokens
    bias.copy_(saved)
    assert eng.generate(ENGINE_PROMPTS, max_new_tokens=33).tokens == first.tokens
    assert len(eng.graphs) == 1


@pytest.mark.parametrize("arch", ["mixtral", "qwen3moe", "qwen2moe", "ernie4_5-moe"])
def test_moe_decode_skip_equals_loop_on_card(cuda, monkeypatch, arch):
    """Decode steps (B = 4, T = 1, after a 40-token prefill) with the expert
    skip against the same steps with every expert through A (moe_route
    forced to the loop), on the card in bf16: logits equal bit for bit at
    every step, and the skip launches A's variant three times a MoE layer a
    step (gate, up, down), whatever E is (ernie4_5-moe: the biased
    selection, its dense first layer without a launch)."""
    import tpullm_torch.models.llama as llama
    from tpullm_torch.models.llama import KVCache, forward
    from tpullm_torch.utils.synth import synth_mixtral_q4k

    if arch == "mixtral":
        cfg, params = synth_mixtral_q4k(vocab_size=512, n_embd=512, n_layer=2, n_head=4,
                                        n_head_kv=2, n_ff=1024, n_expert=4, n_expert_used=2,
                                        seed=3, device="cuda")
    else:
        cfg, params = _moe_card(arch, device="cuda")
    g = torch.Generator(device=cuda).manual_seed(2)
    B, T, steps = 4, 40, 4
    tok = torch.randint(0, 500, (B, T + steps), generator=g, device=cuda)
    pos = torch.arange(T + steps, device=cuda).repeat(B, 1)
    vf = torch.zeros(B, dtype=torch.int64, device=cuda)
    route = llama.moe_route
    out = {}
    for way in ("skip", "loop"):
        if way == "loop":
            monkeypatch.setattr(llama, "moe_route",
                                lambda *a: "loop" if a[1] <= 16 else route(*a))
        cache = KVCache.create(cfg, B, 64, torch.bfloat16, cuda)
        with torch.inference_mode():
            forward(params, cfg, tok[:, :T], pos[:, :T], cache, 0, vf)
            _cuda.reset_counts()
            out[way] = [forward(params, cfg, tok[:, T + i: T + i + 1], pos[:, T + i: T + i + 1],
                                cache, T + i, vf, kv_view_len=64)[0] for i in range(steps)]
            out[way + "_counts"] = dict(_cuda.COUNTS)
    for a, b in zip(out["skip"], out["loop"]):
        assert torch.equal(a, b)
    n_moe = cfg.n_layer - cfg.n_layer_dense_lead
    assert out["skip_counts"]["qmm_experts"] == 3 * n_moe * steps, out["skip_counts"]
    assert out["loop_counts"]["qmm_experts"] == 0


def _decode_inputs(cuda, q8, B=4, T=1, H=8, Hkv=2, S=1024, D=128, slots=(900, 300, 40, 5),
                   valid_from=(0, 3, 1, 7), seed=0):
    """Kernel E's operands: K/V (B, Hkv, S, D) as strided views of a
    layer-stacked cache (layer 1 of 2), bf16 or int8 with f32 row scales."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((B, T, H, D), generator=g, device=cuda).to(torch.bfloat16)
    if q8:
        kv = torch.randint(-127, 128, (2, 2, B, Hkv, S, D), generator=g, device=cuda,
                           dtype=torch.int8)
        sc = torch.rand((2, 2, B, Hkv, S), generator=g, device=cuda) * 0.02
        k, v, ks, vs = kv[0, 1], kv[1, 1], sc[0, 1], sc[1, 1]
    else:
        kv = torch.randn((2, 2, B, Hkv, S, D), generator=g, device=cuda).to(torch.bfloat16)
        k, v, ks, vs = kv[0, 1], kv[1, 1], None, None
    qs = torch.tensor(slots[:B], device=cuda)[:, None] + torch.arange(T, device=cuda)[None]
    vf = torch.tensor(valid_from[:B], device=cuda)
    return q, k, v, ks, vs, qs, qs - vf[:, None], vf, g


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("T", [1, 4, 8])
@pytest.mark.parametrize("flags", ["plain", "window", "chunked", "softcap_sinks"])
def test_flash_decode_kernel_vs_plain(cuda, q8, T, flags):
    """Kernel E vs its plain version: the same arithmetic, with f32 sums in
    another order and p rounded to bf16 against each 16-slot chunk's
    running max instead of the row max: NMSE < 1e-4. At T = 1 row 3 (slot
    5, valid_from 7) sees no key and outputs exactly 0. Two calls give
    identical bits."""
    from tpullm_torch.ops.flash_decode import flash_decode, flash_decode_plain

    q, k, v, ks, vs, qs, pos, vf, g = _decode_inputs(cuda, q8, T=T)
    window = {"window": 100, "chunked": 64}.get(flags, 0)
    cfg = ModelConfig(n_head=8, n_head_kv=2, head_dim=128, head_dim_v=128,
                      attn_logit_softcap=30.0 if flags == "softcap_sinks" else 0.0,
                      swa_chunked=flags == "chunked")
    sinks = (torch.randn(8, generator=g, device=cuda) if flags == "softcap_sinks" else None)
    before = _cuda.COUNTS["flash_decode"]
    a = flash_decode(q, k, v, qs, pos, vf, cfg, window, sinks, k_scales=ks, v_scales=vs)
    b = flash_decode(q, k, v, qs, pos, vf, cfg, window, sinks, k_scales=ks, v_scales=vs)
    want = flash_decode_plain(q, k, v, qs, pos, vf, 128 ** -0.5, cfg.attn_logit_softcap,
                              window, cfg.swa_chunked, sinks, ks, vs)
    torch.cuda.synchronize()
    assert _cuda.COUNTS["flash_decode"] == before + 2
    assert torch.equal(a, b)
    assert a.shape == want.shape == (4, T, 8, 128)
    if T == 1:
        assert torch.count_nonzero(a[3]) == 0 and torch.count_nonzero(want[3]) == 0
    assert _nmse(a, want) < 1e-4


@pytest.mark.parametrize("q8", [False, True])
def test_flash_decode_kernel_big_head_mqa(cuda, q8):
    """Head dim 256 with one kv head (MQA), G * T = 8 rows per kv head."""
    from tpullm_torch.ops.flash_decode import flash_decode, flash_decode_plain

    q, k, v, ks, vs, qs, pos, vf, _ = _decode_inputs(cuda, q8, B=2, T=2, H=4, Hkv=1, S=512,
                                                     D=256, slots=(400, 100))
    cfg = ModelConfig(n_head=4, n_head_kv=1, head_dim=256, head_dim_v=256)
    got = flash_decode(q, k, v, qs, pos, vf, cfg, k_scales=ks, v_scales=vs)
    want = flash_decode_plain(q, k, v, qs, pos, vf, 256 ** -0.5, 0.0, 0, False, None, ks, vs)
    torch.cuda.synchronize()
    assert _nmse(got, want) < 1e-4


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("heads,T", [((16, 2), 8), ((64, 1), 1), ((12, 4), 4), ((40, 8), 8)],
                         ids=["G8T8", "G64T1", "G3T4", "G5T8"])
def test_flash_decode_kernel_query_rows(cuda, D, q8, heads, T):
    """Every count of query rows a kv head may have, up to E_RMAX = 64:
    G * T = 64 (one m-tile a warp), 12 (one m-tile, its rows padded) and 40
    (three m-tiles, so one warp has no rows), at head dims 128 and 256,
    bf16 and int8, against the plain version (NMSE < 1e-4), two calls
    bit-identical."""
    from tpullm_torch.ops.flash_decode import flash_decode, flash_decode_plain

    H, Hkv = heads
    q, k, v, ks, vs, qs, pos, vf, _ = _decode_inputs(cuda, q8, B=2, T=T, H=H, Hkv=Hkv, S=768,
                                                     D=D, slots=(700, 300), valid_from=(0, 5))
    cfg = ModelConfig(n_head=H, n_head_kv=Hkv, head_dim=D, head_dim_v=D)
    got = flash_decode(q, k, v, qs, pos, vf, cfg, k_scales=ks, v_scales=vs)
    again = flash_decode(q, k, v, qs, pos, vf, cfg, k_scales=ks, v_scales=vs)
    want = flash_decode_plain(q, k, v, qs, pos, vf, D ** -0.5, 0.0, 0, False, None, ks, vs)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _nmse(got, want) < 1e-4


@pytest.mark.parametrize("q8", [False, True])
def test_flash_decode_kernel_server_shape(cuda, q8):
    """The server's decode shape (4 rows at slots 6000/2000/700/40 of an
    8192-slot view, 32/8 heads): up to 47 live splits a row, merged in two
    levels, with many blocks in flight at once. Three calls give identical
    bits, within NMSE 1e-4 of the plain version."""
    from tpullm_torch.ops.flash_decode import flash_decode, flash_decode_plain

    q, k, v, ks, vs, qs, pos, vf, _ = _decode_inputs(
        cuda, q8, B=4, T=1, H=32, Hkv=8, S=8192, slots=(6000, 2000, 700, 40),
        valid_from=(0, 0, 0, 0))
    cfg = ModelConfig(n_head=32, n_head_kv=8, head_dim=128, head_dim_v=128)
    outs = [flash_decode(q, k, v, qs, pos, vf, cfg, k_scales=ks, v_scales=vs) for _ in range(3)]
    want = flash_decode_plain(q, k, v, qs, pos, vf, 128 ** -0.5, 0.0, 0, False, None, ks, vs)
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert _nmse(outs[0], want) < 1e-4


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("q8", [False, True])
def test_flash_decode_kernel_split_edges(cuda, D, q8):
    """Rows whose newest slot sits on a 128-slot split's edges (127, 128,
    129, 255, 256), at slot 0 and at the view's last slot (S - 1), some with
    their first visible slot mid-split: each row within NMSE 1e-4 of the
    plain version, two calls bit-identical."""
    from tpullm_torch.ops.flash_decode import flash_decode, flash_decode_plain

    slots = (127, 128, 129, 255, 256, 0, 511)
    q, k, v, ks, vs, qs, pos, vf, _ = _decode_inputs(
        cuda, q8, B=len(slots), T=1, H=8, Hkv=2, S=512, D=D, slots=slots,
        valid_from=(0, 120, 127, 1, 200, 0, 130))
    cfg = ModelConfig(n_head=8, n_head_kv=2, head_dim=D, head_dim_v=D)
    got = flash_decode(q, k, v, qs, pos, vf, cfg, k_scales=ks, v_scales=vs)
    again = flash_decode(q, k, v, qs, pos, vf, cfg, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for b in range(len(slots)):
        # each row alone, so the plain version reads only that row's slots
        sl = slice(b, b + 1)
        want = flash_decode_plain(q[sl], k[sl], v[sl], qs[sl], pos[sl], vf[sl], D ** -0.5, 0.0,
                                  0, False, None, None if ks is None else ks[sl],
                                  None if vs is None else vs[sl])
        assert _nmse(got[sl], want) < 1e-4, (b, slots[b])


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("heads,T", [((8, 8), 1), ((8, 8), 4), ((8, 8), 8), ((16, 2), 1),
                                     ((16, 2), 4), ((16, 2), 8), ((48, 1), 1)],
                         ids=["G1T1", "G1T4", "G1T8", "G8T1", "G8T4", "G8T8", "G48T1"])
def test_flash_decode_kernel_alibi(cuda, monkeypatch, q8, heads, T):
    """Kernel E with ALiBi (alibi_max_bias 8) against its plain version
    with the same slopes, at GQA groups of 1, 8 and 48 (G * T <= 64), bf16
    and int8: NMSE < 1e-4, two calls bit-identical, at T = 1 the row with no
    visible key exactly 0. The term is one exact FMA: with slopes of 0 the
    kernel gives its bits without slopes."""
    from tpullm_torch.ops.flash_decode import flash_decode, flash_decode_plain

    H, Hkv = heads
    q, k, v, ks, vs, qs, pos, vf, _ = _decode_inputs(cuda, q8, T=T, H=H, Hkv=Hkv)
    bare_cfg = ModelConfig(n_head=H, n_head_kv=Hkv, head_dim=128, head_dim_v=128)
    cfg = dataclasses.replace(bare_cfg, use_rope=False, alibi_max_bias=8.0)
    before = _cuda.COUNTS["flash_decode"]
    a = flash_decode(q, k, v, qs, pos, vf, cfg, k_scales=ks, v_scales=vs)
    b = flash_decode(q, k, v, qs, pos, vf, cfg, k_scales=ks, v_scales=vs)
    want = flash_decode_plain(q, k, v, qs, pos, vf, 128 ** -0.5, 0.0, 0, False, None, ks, vs,
                              slopes=alibi_of(cfg, cuda))
    bare = flash_decode(q, k, v, qs, pos, vf, bare_cfg, k_scales=ks, v_scales=vs)
    monkeypatch.setattr(fd, "alibi_of", lambda c, dev: torch.zeros(H, device=dev))
    zero = flash_decode(q, k, v, qs, pos, vf, bare_cfg, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert _cuda.COUNTS["flash_decode"] == before + 4
    assert torch.equal(a, b) and torch.equal(zero, bare)
    if T == 1:
        assert torch.count_nonzero(a[3]) == 0 and torch.count_nonzero(want[3]) == 0
    assert _nmse(a, want) < 1e-4
    assert _nmse(bare, a) > 1e-3


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("heads", [(32, 32), (48, 1)], ids=["bloom", "starcoder"])
def test_flash_decode_kernel_alibi_server_shape(cuda, q8, heads):
    """ALiBi at the server's decode shape (4 rows at slots 6000/2000/700/40
    of an 8192-slot view) at BLOOM-7b1's heads (32/32) and StarCoder's
    (48/1): up to 47 live splits a row merged in two levels; three calls
    bit-identical, within NMSE 1e-4 of the plain version."""
    from tpullm_torch.ops.flash_decode import flash_decode, flash_decode_plain

    H, Hkv = heads
    q, k, v, ks, vs, qs, pos, vf, _ = _decode_inputs(
        cuda, q8, B=4, T=1, H=H, Hkv=Hkv, S=8192, slots=(6000, 2000, 700, 40),
        valid_from=(0, 0, 0, 0))
    cfg = ModelConfig(n_head=H, n_head_kv=Hkv, head_dim=128, head_dim_v=128, use_rope=False,
                      alibi_max_bias=8.0)
    outs = [flash_decode(q, k, v, qs, pos, vf, cfg, k_scales=ks, v_scales=vs) for _ in range(3)]
    want = flash_decode_plain(q, k, v, qs, pos, vf, 128 ** -0.5, 0.0, 0, False, None, ks, vs,
                              slopes=alibi_of(cfg, cuda))
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert _nmse(outs[0], want) < 1e-4


def test_flash_decode_kernel_refuses(cuda):
    """No fallback on the card: head dims not built, too many rows per kv
    head, or K/V of another type raise."""
    from tpullm_torch.ops.flash_decode import flash_decode

    q, k, v, ks, vs, qs, pos, vf, _ = _decode_inputs(cuda, False, B=1, T=1, S=256)
    cfg = ModelConfig(n_head=8, n_head_kv=2, head_dim=128, head_dim_v=128)
    with pytest.raises(NotImplementedError, match="head dims"):
        flash_decode(q[..., :96].contiguous(), k[..., :96], v[..., :96], qs, pos, vf, cfg)
    with pytest.raises(ValueError, match="expected"):
        flash_decode(q, k.float(), v.float(), qs, pos, vf, cfg)
    q9 = torch.zeros((1, 9, 8, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="T=9"):
        flash_decode(q9, k, v, qs.expand(1, 9), pos.expand(1, 9), vf, cfg)


def test_flash_decode_kernel_refuses_other_split(cuda, monkeypatch):
    """The wrapper sizes the partials for ceil(S / E_CH[int8]) splits; the
    kernel writes one partial a split of its own length and rejects any
    other split count, so a wrapper out of step with it raises instead of
    writing past the partials."""
    import tpullm_torch.ops.flash_decode as fd

    q, k, v, ks, vs, qs, pos, vf, _ = _decode_inputs(cuda, False, B=1, T=1, S=256)
    cfg = ModelConfig(n_head=8, n_head_kv=2, head_dim=128, head_dim_v=128)
    for ch in (64, 256):
        monkeypatch.setattr(fd, "E_CH", {False: ch, True: ch})
        with pytest.raises(RuntimeError, match="flash_decode: CUDA error"):
            fd.flash_decode(q, k, v, qs, pos, vf, cfg)


def test_server_layout_forward_kernel_e_on_vs_off(cuda, monkeypatch):
    """The server layout on the card with a q8 cache: per-slot prefills
    through slot0, then decode steps with a per-row cache_pos, once with
    TPULLM_FLASH_DECODE set (kernel E reads the int8 rows) and once without
    (the einsum path over dequantized views). Same inputs, logits within
    NMSE 1e-4 of each other, kernel E launched only in the first run."""
    from tpullm_torch.models.llama import KVCache, forward
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    cfg, params = synth_kmajor_q4k_fast(vocab_size=512, n_embd=512, n_layer=2, n_head=4,
                                        n_head_kv=2, n_ff=1024, seed=3, centred=True,
                                        device="cuda")
    lens = [100, 37, 300]
    out = {}
    for flag in ("1", None):
        if flag:
            monkeypatch.setenv("TPULLM_FLASH_DECODE", flag)
        else:
            monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
        cache = KVCache.create(cfg, 3, 512, "q8", cuda)
        _cuda.reset_counts()
        with torch.inference_mode():
            for slot, n in enumerate(lens):
                Tb = 128 if n <= 128 else 512
                tok = torch.zeros((1, Tb), dtype=torch.int64, device=cuda)
                tok[0, :n] = torch.arange(n, device=cuda) % 500 + slot
                pos = torch.arange(Tb, device=cuda)[None]
                forward(params, cfg, tok, pos, cache, 0, torch.zeros(1, dtype=torch.int64,
                                                                     device=cuda),
                        slot0=slot, logits_idx=n - 1)
            cp = torch.tensor(lens, device=cuda)
            tok = torch.tensor([[7], [8], [9]], device=cuda)
            logits = []
            for _ in range(3):
                lg, _ = forward(params, cfg, tok, cp[:, None], cache, cp,
                                torch.zeros(3, dtype=torch.int64, device=cuda),
                                kv_view_len=512)
                logits.append(lg[:, -1].float())
                tok = lg[:, -1].argmax(-1, keepdim=True)
                cp = cp + 1
        torch.cuda.synchronize()
        out[flag] = (torch.stack(logits), dict(_cuda.COUNTS))
    assert out["1"][1]["flash_decode"] == 3 * cfg.n_layer, out["1"][1]
    assert out[None][1]["flash_decode"] == 0
    assert _nmse(out["1"][0], out[None][0]) < 1e-4


def _synth_card(kind):
    """The 2-layer synth models of the engine tests above, on the card:
    "dense" (n_embd 512, head dim 128), "hd256" (n_embd 1024, head dim 256),
    "moe" (4 experts, top-2) and "qwen3moe" (16 experts, top-4, decode
    through the expert skip)."""
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast, synth_mixtral_q4k

    if kind == "qwen3moe":
        return _moe_card("qwen3moe", vocab_size=512, exact_vocab=False, device="cuda")
    if kind == "moe":
        return synth_mixtral_q4k(vocab_size=512, n_embd=512, n_layer=2, n_head=4, n_head_kv=2,
                                 n_ff=1024, n_expert=4, n_expert_used=2, seed=3, device="cuda")
    return synth_kmajor_q4k_fast(vocab_size=512, n_embd=1024 if kind == "hd256" else 512,
                                 n_layer=2, n_head=4, n_head_kv=2, n_ff=1024, seed=3,
                                 centred=True, device="cuda")


ENGINE_PROMPTS = [list(range(1, 101)), list(range(7, 67)), list(range(40, 70))]


def _counters_zero(*owners):
    """Kernel D's and every buffer of kernel E's arrival counters read 0: the
    devices' shared ones and those of each owner (an engine's decode states,
    a server)."""
    from tpullm_torch.ops import flash_decode, layer_kernel

    torch.cuda.synchronize()
    bufs = list(flash_decode._HELD)
    if layer_kernel._counters.cache_info().currsize:
        bufs.append(layer_kernel._counters(torch.cuda.current_device()))
    for o in owners:
        if hasattr(o, "states"):  # an engine: each batch size's own
            bufs += [t for st in o.states.values() for t in st.counters.values()]
        else:
            bufs += list(o.counters.values())
    return all(int(b.abs().sum()) == 0 for b in bufs)


@pytest.mark.parametrize("kind,flag", [("dense", None), ("dense", "1"), ("hd256", None),
                                       ("hd256", "1"), ("moe", None), ("qwen3moe", None)])
def test_engine_graph_matches_eager(cuda, monkeypatch, kind, flag):
    """The decode step as a replayed CUDA graph against the same step run
    eagerly (cuda_graphs=False), on the engine tests' 2-layer models: 128
    steps in chunks of 24 and a short one of 8 that ends at the cache's last
    slot; identical greedy tokens and first logits, equal launch counts
    (each replay adds its capture's), one graph for the one key, sampled
    tokens equal at one seed and a repeat identical, and D's and E's
    arrival counters all zero after the mix."""
    from tpullm_torch.ops.sampling import SamplerConfig
    from tpullm_torch.runtime.engine import InferenceEngine

    if flag:
        monkeypatch.setenv("TPULLM_FLASH_DECODE", flag)
    else:
        monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
    cfg, params = _synth_card(kind)
    res, counts = {}, {}
    engines = {}
    for graphs in (True, False):
        eng = engines[graphs] = InferenceEngine(cfg, params, max_seq_len=256,
                                                decode_chunk=24, cuda_graphs=graphs)
        _cuda.reset_counts()
        res[graphs] = eng.generate(ENGINE_PROMPTS, max_new_tokens=129, return_logits=True)
        counts[graphs] = dict(_cuda.COUNTS)
    assert all(len(t) == 129 for t in res[True].tokens)
    assert res[True].tokens == res[False].tokens
    assert (res[True].logits == res[False].logits).all()
    assert counts[True] == counts[False], counts
    assert (counts[True]["flash_decode"] > 0) == bool(flag), counts
    assert (counts[True]["layer_kernel"] > 0) == (kind not in ("moe", "qwen3moe")), counts
    assert (counts[True]["qmm_experts"] > 0) == (kind in ("moe", "qwen3moe")), counts
    assert len(engines[True].graphs) == 1 and not engines[False].graphs
    sampled = SamplerConfig(temperature=0.8, top_k=40, top_p=0.9)
    s = {g: engines[g].generate(ENGINE_PROMPTS, max_new_tokens=40, sampler=sampled, seed=3)
         for g in (True, False)}
    again = engines[True].generate(ENGINE_PROMPTS, max_new_tokens=40, sampler=sampled, seed=3)
    assert again.tokens == s[True].tokens
    assert s[True].tokens == s[False].tokens
    assert len(engines[True].graphs) == 2
    assert _counters_zero(*engines.values())


def test_engine_graphs_across_batch_sizes_and_lengths(cuda, monkeypatch):
    """A second generate with another batch size and prompt bucket adds its
    own graph and buffers; a third with the first batch reuses the first
    graph; with kernel E's flag flipped between calls the route keys a
    graph of its own; every call's tokens equal the eager engine's, and D's
    and E's counters read zero after the mix of replays and eager runs."""
    from tpullm_torch.runtime.engine import InferenceEngine

    monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
    cfg, params = _synth_card("dense")
    g, e = (InferenceEngine(cfg, params, max_seq_len=512, decode_chunk=16, cuda_graphs=c)
            for c in (True, False))
    calls = [(ENGINE_PROMPTS, None), ([list(range(3, 203)), list(range(9, 29))], None),
             (ENGINE_PROMPTS, None), (ENGINE_PROMPTS, "1"),
             ([list(range(3, 203)), list(range(9, 29))], "1")]
    keys = []
    for prompts, flag in calls:
        if flag:
            monkeypatch.setenv("TPULLM_FLASH_DECODE", flag)
        else:
            monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
        a = g.generate(prompts, max_new_tokens=40)
        b = e.generate(prompts, max_new_tokens=40)
        assert a.tokens == b.tokens
        keys.append(sorted(g.graphs, key=str))
    assert [len(k) for k in keys] == [1, 2, 2, 3, 4]
    assert sorted(g.states) == [2, 3]
    assert _counters_zero(g, e)


def test_engine_capture_failure_raises(cuda, monkeypatch):
    """A step that cannot be captured (here a sampler that reads a value
    back to the host) raises from generate; no graph is kept and the engine
    never falls back to eager steps: the next call raises too."""
    from tpullm_torch.runtime import engine as engine_mod

    make = engine_mod.make_sample_fn

    def reading_sampler(cfg):
        fn = make(cfg)

        def sample(logits, gen=None):
            tok = fn(logits, gen)
            float(logits.sum())  # a host read: refused inside a capture
            return tok

        return sample

    monkeypatch.setattr(engine_mod, "make_sample_fn", reading_sampler)
    cfg, params = _synth_card("dense")
    eng = engine_mod.InferenceEngine(cfg, params, max_seq_len=256, decode_chunk=4)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            eng.generate(ENGINE_PROMPTS, max_new_tokens=5)
        assert eng.graphs == {}
    torch.cuda.synchronize()


def _store_case(cuda, g, B, T, Hkv, D, Dv, rows_dtype, bank, S, B_cache, strided):
    """Rows (B, T, Hkv, D/Dv) (V a slice of a fused output when strided) and
    banks of one layer holding random content."""
    y = torch.randn((B, T, Hkv * (D + Dv) + 64), generator=g, device=cuda) * 3
    y[0, 0, :D] = 0  # an all-zero K row: scale 0, values 0
    y = y.to(rows_dtype)
    k = y[..., : Hkv * D].reshape(B, T, Hkv, D).contiguous()
    v = y[..., Hkv * D: Hkv * (D + Dv)].reshape(B, T, Hkv, Dv)
    if not strided:
        v = v.contiguous()
    if bank == "q8":
        banks = [torch.randint(-127, 128, (B_cache, Hkv, S, d), generator=g, device=cuda,
                               dtype=torch.int8) for d in (D, Dv)]
        banks += [torch.rand((B_cache, Hkv, S), generator=g, device=cuda) for _ in range(2)]
    else:
        banks = [torch.randn((B_cache, Hkv, S, d), generator=g, device=cuda).to(bank)
                 for d in (D, Dv)] + [None, None]
    return k, v, banks


# (B, T, Hkv, D, Dv, first slots, b0, S, cache rows): the server's decode step,
# a 512-row prefill chunk, the engine's decode step and 4x512 prefill, head
# dim 256, and writes past the cache's end
STORE_SHAPES = {
    "server_decode": (4, 1, 8, 128, 128, [6000, 2000, 700, 40], 0, 8192, 4),
    "prefill_512": (1, 512, 8, 128, 128, [5632], 2, 8192, 4),
    "engine_decode": (4, 1, 8, 128, 128, [540] * 4, 0, 1024, 4),
    "engine_prefill": (4, 512, 8, 128, 128, [0] * 4, 0, 1024, 4),
    "head_dim_256": (4, 1, 4, 256, 256, [1000, 17, 0, 1023], 0, 1024, 4),
    "past_the_end": (2, 16, 2, 128, 64, [1016, 1030], 1, 1024, 3),
    # one kv head (StarCoder's multi-query attention): its decode step and chunk
    "mqa_decode": (4, 1, 1, 128, 128, [6000, 2000, 700, 40], 0, 8192, 4),
    "mqa_prefill_512": (1, 512, 1, 128, 128, [5632], 2, 8192, 4),
    # MLA's compressed rows (DeepSeek-V2-Lite: one head, K [c_kv; k_pe] 576,
    # V c_kv 512): the server's decode step and chunk, the engine's step
    "mla_decode": (4, 1, 1, 576, 512, [2000, 700, 300, 40], 0, 4096, 4),
    "mla_prefill_512": (1, 512, 1, 576, 512, [1536], 2, 4096, 4),
    "mla_engine_decode": (4, 1, 1, 576, 512, [540] * 4, 0, 1024, 4),
    # gpt-oss-20b's 8 kv heads of 64: its q8 server's decode step and chunk
    "head_dim_64_decode": (4, 1, 8, 64, 64, [2000, 700, 300, 40], 0, 4096, 4),
    "head_dim_64_prefill_512": (1, 512, 8, 64, 64, [1536], 2, 4096, 4),
}


@pytest.mark.parametrize("shape", list(STORE_SHAPES))
@pytest.mark.parametrize("bank,rows_dtype", [("q8", torch.bfloat16), ("q8", torch.float32),
                                             (torch.bfloat16, torch.bfloat16),
                                             (torch.float32, torch.bfloat16),
                                             (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("strided", [False, True])
def test_kv_store_kernel_vs_plain(cuda, shape, bank, rows_dtype, strided):
    """The store kernel equals its plain version bit for bit on every bank
    (int8 values and f32 row scales, bf16, f32), rows left alone included,
    in one launch for K and V; writes at or past the cache's end dropped."""
    from tpullm_torch.ops.kv_store import kv_store, kv_store_plain

    B, T, Hkv, D, Dv, first, b0, S, B_cache = STORE_SHAPES[shape]
    g = torch.Generator(device=cuda).manual_seed(sum(first) + T)
    k, v, banks = _store_case(cuda, g, B, T, Hkv, D, Dv, rows_dtype, bank, S, B_cache,
                              strided)
    twin = [None if b is None else b.clone() for b in banks]
    before = banks[0].clone()
    slot = torch.tensor(first, dtype=torch.int64, device=cuda)
    _cuda.reset_counts()
    kv_store(banks[0], banks[1], k, v, slot, b0, banks[2], banks[3])
    assert _cuda.COUNTS["kv_store"] == 1
    kv_store_plain(twin[0], twin[1], k, v, slot, b0, twin[2], twin[3])
    torch.cuda.synchronize()
    for a, b in zip(banks, twin):
        if a is not None:
            assert torch.equal(a, b)
    assert (banks[0] != before).any()
    _cuda.reset_counts()


def test_kv_store_kernel_refuses(cuda):
    """Rows or banks of a type the kernel does not build, mismatched heads,
    or a slot tensor that is not int64 raise on the card."""
    from tpullm_torch.ops.kv_store import kv_store

    g = torch.Generator(device=cuda).manual_seed(0)
    k, v, banks = _store_case(cuda, g, 2, 1, 2, 128, 128, torch.bfloat16, "q8", 64, 2, False)
    slot = torch.tensor([3, 4], device=cuda)
    with pytest.raises(ValueError, match="not built"):
        kv_store(banks[0], banks[1], k.half(), v.half(), slot, 0, banks[2], banks[3])
    with pytest.raises(ValueError, match="not built"):
        kv_store(banks[0], banks[1], k, v, slot, 0)  # int8 banks without their scales
    with pytest.raises(ValueError, match="slot"):
        kv_store(banks[0], banks[1], k, v, slot.int(), 0, banks[2], banks[3])
    with pytest.raises(ValueError, match="cache rows"):
        kv_store(banks[0], banks[1], k, v, slot, 1, banks[2], banks[3])


SERVER_REQS = [  # (prompt length, GenParams kwargs): 6 requests on 4 slots
    (100, dict(max_tokens=20, temperature=0.0, n_probs=4, seed=0)),
    (300, dict(max_tokens=11, temperature=0.8, top_k=40, seed=7)),
    (37, dict(max_tokens=16, temperature=0.0, penalty_repeat=1.3, dry_multiplier=0.8, seed=0)),
    (64, dict(max_tokens=9, temperature=1.0, mirostat=2, mirostat_tau=4.0, seed=3)),
    (45, dict(max_tokens=14, temperature=0.7, top_p=0.9, seed=11, n_probs=2)),
    (200, dict(max_tokens=12, temperature=0.0, seed=0)),
]


def _server_run(ctx, prompts):
    """The requests, submitted at once to a running loop -> [done payload]."""
    from tpullm_torch.server.context import GenParams, Task

    tasks = [Task(tokens=p, params=GenParams(**kw))
             for p, (_, kw) in zip(prompts, SERVER_REQS)]
    ctx.start()
    try:
        ctx.control(lambda: [ctx.submit(t) for t in tasks])
        out = []
        for t in tasks:
            done = [p for k, p in t.events() if k == "done"]
            assert done, "task failed"
            out.append(done[0])
        return out
    finally:
        ctx.stop()


@pytest.mark.parametrize("flag", [None, "1"])
def test_server_graph_matches_eager(cuda, monkeypatch, flag):
    """The server's decode step as replayed CUDA graphs against the same
    step run eagerly (cuda_graphs=False) on the 2-layer synth model with an
    int8 cache: 6 requests on 4 slots, the last two admitted between chunks
    with another sampler and a reseed of the draw stream, which the replays
    follow; identical greedy and sampled tokens, equal logprobs, equal
    launch counts (the store kernel among them), one graph a key, and D's
    and E's arrival counters all zero after."""
    from tpullm_torch.server.context import ServerContext

    if flag:
        monkeypatch.setenv("TPULLM_FLASH_DECODE", flag)
    else:
        monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
    cfg, params = _synth_card("dense")
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
               for n, _ in SERVER_REQS]
    res, counts, ctxs = {}, {}, {}
    for graphs in (True, False):
        ctx = ctxs[graphs] = ServerContext(cfg, params, None, n_slots=4, max_seq_len=1024,
                                           decode_chunk=8, prefill_chunk=128, kv_dtype="q8",
                                           cuda_graphs=graphs)
        _cuda.reset_counts()
        res[graphs] = _server_run(ctx, prompts)
        counts[graphs] = dict(_cuda.COUNTS)
    for a, b, (_, kw) in zip(res[True], res[False], SERVER_REQS):
        assert a["tokens"] == b["tokens"] and len(a["tokens"]) == kw["max_tokens"]
        assert a.get("logprobs") == b.get("logprobs")
    assert counts[True] == counts[False], counts
    assert counts[True]["kv_store"] > 0 and counts[True]["layer_kernel"] > 0
    assert (counts[True]["flash_decode"] > 0) == bool(flag), counts
    assert ctxs[True].graphs and not ctxs[False].graphs
    assert all(k[3] == ("flash_decode" if flag else "einsum") for k in ctxs[True].graphs)
    assert _counters_zero(*ctxs.values())


def test_counters_race_engine_and_server(cuda, monkeypatch):
    """An engine's generate and a server's decode chunks run at once from two
    threads on two streams, both through kernels D and E and as graph
    replays: each gives the tokens it gives alone, and every arrival
    counter reads zero after (each owner launches on its own)."""
    import threading

    from tpullm_torch.runtime.engine import InferenceEngine
    from tpullm_torch.server.context import GenParams, ServerContext, Task

    monkeypatch.setenv("TPULLM_FLASH_DECODE", "1")
    cfg, params = _synth_card("dense")
    eng = InferenceEngine(cfg, params, max_seq_len=1024, decode_chunk=16)
    prompts = [list(range(1, 301)), list(range(7, 207)), list(range(40, 90)), [5] * 30]

    def server_tokens():
        ctx = ServerContext(cfg, params, None, n_slots=4, max_seq_len=1024, decode_chunk=8,
                            prefill_chunk=512, kv_dtype="q8")
        with torch.inference_mode():
            for p in prompts:
                ctx.submit(Task(tokens=p, params=GenParams(max_tokens=10 ** 6,
                                                           temperature=0.0, seed=0)))
            ctx._admit()
            while any(r.pending for r in ctx.rt):
                for i, r in enumerate(ctx.rt):
                    if r.pending:
                        ctx._prefill_step(i)
            for _ in range(12):
                ctx._decode_step()
            torch.cuda.synchronize()
        return ctx, [list(r.gen) for r in ctx.rt]

    alone_eng = eng.generate(prompts, max_new_tokens=120).tokens
    _, alone_srv = server_tokens()
    out = {}

    def run(name, fn):
        s = torch.cuda.Stream(cuda)
        with torch.cuda.stream(s):
            out[name] = fn()
        s.synchronize()

    threads = [threading.Thread(target=run, args=("eng", lambda: eng.generate(
                   prompts, max_new_tokens=120).tokens)),
               threading.Thread(target=run, args=("srv", server_tokens))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive(), "a thread did not finish"
    ctx, together_srv = out["srv"]
    assert out["eng"] == alone_eng
    assert together_srv == alone_srv and all(len(x) == 96 for x in together_srv)
    assert _counters_zero(eng, ctx)


def test_server_chat_on_card_matches_cpu(cuda, monkeypatch):
    """Chat on the card: a 2-layer synth Llama with a byte-level BPE vocab
    (Llama-3's layout and chat template) served with an int8 cache and
    kernel E, against the same server on the CPU at f32. The rendered
    prompts' token ids are equal; each prompt's next-token logits are
    within 4x the NMSE of the CPU path in bf16 (the engine test's bound);
    greedy tokens from one generator state are equal up to the first step
    whose top two CPU logprobs lie within 0.05; and the card's answer over
    HTTP is 200 with its text the decode of its tokens."""
    import json
    import socket
    import urllib.request

    from tpullm_torch.server.chat import apply_chat_template
    from tpullm_torch.server.context import GenParams, ServerContext, prefill_chunk
    from tpullm_torch.server.http import serve
    from tpullm_torch.tokenizer import Tokenizer
    from tpullm_torch.utils.synth import synth_bpe_vocab, synth_kmajor_q4k_fast

    monkeypatch.setenv("TPULLM_FLASH_DECODE", "1")
    tok = Tokenizer(synth_bpe_vocab(1024, seed=4))
    cfg, params = synth_kmajor_q4k_fast(vocab_size=1024, n_embd=512, n_layer=2, n_head=4,
                                        n_head_kv=2, n_ff=1024, seed=3, centred=True,
                                        device="cpu")
    card = {k: (v.to("cuda") if not isinstance(v, dict) else
                {n: t.to("cuda") for n, t in v.items()}) for k, v in params.items()}
    chats = [[{"role": "user", "content": "What is the capital of France?"}],
             [{"role": "system", "content": "answer in one word"},
              {"role": "user", "content": "Name a colour of the sky at noon."}]]
    common = dict(n_slots=2, max_seq_len=512, decode_chunk=8, prefill_chunk=256,
                  kv_dtype="q8")
    ctxs = {"card": ServerContext(cfg, card, tok, **common),
            "cpu": ServerContext(cfg, params, tok, compute_dtype=torch.float32, device="cpu",
                                 **common),
            "cpu_bf16": ServerContext(cfg, params, tok, device="cpu", **common)}
    prompts = [tok.encode(apply_chat_template(ctxs["card"], m), True, True) for m in chats]
    assert prompts == [tok.encode(apply_chat_template(ctxs["cpu"], m), True, True)
                       for m in chats]
    logits = {}
    with torch.inference_mode():
        for name, ctx in ctxs.items():
            logits[name] = torch.cat([prefill_chunk(ctx.params, cfg, ctx.memory.cache, 0, 0, p,
                                                    ctx.dtype)[0].float().cpu()
                                      for p in prompts])
            ctx.memory.clear_slot(0)
    ref = _nmse(logits["cpu_bf16"], logits["cpu"])
    assert _nmse(logits["card"], logits["cpu"]) < 4 * ref
    out = {}
    for name in ("card", "cpu"):
        ctx = ctxs[name]
        ctx.start()
        try:
            out[name] = [ctx.generate(list(p), GenParams(max_tokens=24, temperature=0.0,
                                                         seed=0, n_probs=2))
                         for p in prompts]
        finally:
            ctx.stop()
    for a, b in zip(out["card"], out["cpu"]):
        for j, e in enumerate(b["logprobs"]):
            (_, l0), (_, l1) = e["top"][:2]
            if l0 - l1 <= 0.05 or j >= len(a["tokens"]):
                break
            assert a["tokens"][j] == b["tokens"][j], (j, a["tokens"], b["tokens"])
        text = tok.decode(a["tokens"], skip_special=True)
        assert a["text"] == (text[: text.rfind("�")] if text.endswith("�") else text)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = ServerContext(cfg, card, tok, **common)
    srv = serve(ctx, "127.0.0.1", port, block=False)
    try:
        _cuda.reset_counts()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/chat/completions",
            json.dumps({"messages": chats[1], "max_tokens": 16, "temperature": 0}).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            assert r.status == 200
            ans = json.loads(r.read())
        counts = dict(_cuda.COUNTS)
    finally:
        srv.shutdown()
        srv.server_close()
        ctx.stop()
    assert ans["usage"]["prompt_tokens"] == len(prompts[1])
    choice = ans["choices"][0]
    text = tok.decode(choice["tokens"], skip_special=True)
    held = text[: text.rfind("�")] if text.endswith("�") else text
    assert choice["message"]["content"] == held
    assert all(counts[k] > 0 for k in ("qmm_splitk", "layer_kernel", "flash_decode",
                                       "kv_store")), counts


# ----------------------------------------------------------- the iSWA ring
# (B, T, Hkv, D, first slots, ring): the ring server's decode step and a
# 512-row chunk that crosses the end of Gemma-2-9B's 4608-slot ring, and a
# small ring that a 16-row chunk wraps
RING_STORE_SHAPES = {
    "server_decode": (4, 1, 8, 256, [12000, 6000, 2000, 40], 4608),
    "chunk_512_wraps": (1, 512, 8, 256, [4400], 4608),
    "small_ring": (2, 16, 2, 128, [40, 100], 48),
    # gpt-oss-20b's ring server: 8 kv heads of 64, a ring of window 128 + 512
    "head_dim_64_decode": (4, 1, 8, 64, [2000, 700, 300, 40], 640),
    "head_dim_64_chunk_wraps": (1, 512, 8, 64, [1536], 640),
}


@pytest.mark.parametrize("shape", list(RING_STORE_SHAPES))
@pytest.mark.parametrize("bank,rows_dtype", [(torch.bfloat16, torch.bfloat16),
                                             (torch.float32, torch.float32),
                                             (torch.bfloat16, torch.float32)])
def test_kv_store_kernel_ring_wrap(cuda, shape, bank, rows_dtype):
    """The store on an iSWA ring bank (``ring``: row t of a call at slot
    (first + t) % ring, none dropped) equals its plain version bit for bit,
    in one launch, the rows past the ring's end landing at its start."""
    from tpullm_torch.ops.kv_store import kv_store, kv_store_plain

    B, T, Hkv, D, first, ring = RING_STORE_SHAPES[shape]
    g = torch.Generator(device=cuda).manual_seed(ring + T)
    k, v, banks = _store_case(cuda, g, B, T, Hkv, D, D, rows_dtype, bank, ring, B, False)
    twin = [b.clone() for b in banks[:2]]
    slot = torch.tensor(first, dtype=torch.int64, device=cuda)
    _cuda.reset_counts()
    kv_store(banks[0], banks[1], k, v, slot, 0, ring=ring)
    assert _cuda.COUNTS["kv_store"] == 1
    kv_store_plain(twin[0], twin[1], k, v, slot, 0, ring=ring)
    torch.cuda.synchronize()
    assert torch.equal(banks[0], twin[0]) and torch.equal(banks[1], twin[1])
    last = (first[0] + T - 1) % ring
    assert torch.equal(banks[0][0, :, last], k[0, -1].to(bank))
    _cuda.reset_counts()


# (heads, D, ring, window, first slots, valid_from): Gemma-2-9B's ring (4608 =
# 36 splits of 128), a ring that is no multiple of a split (4160) and a small
# odd one (200), the rows past one or more wraps
RING_DECODE_CASES = [
    ((16, 8), 256, 4608, 4096, (12000, 6000, 2000, 40), (0, 0, 0, 0)),
    ((8, 2), 128, 4160, 4096, (9000, 4200, 4159, 3), (0, 100, 0, 0)),
    ((8, 2), 256, 200, 160, (1000, 450, 199, 10), (0, 3, 0, 12)),
    ((4, 1), 128, 200, 160, (333, 201), (0, 250)),
]


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("case", range(len(RING_DECODE_CASES)))
def test_flash_decode_kernel_ring(cuda, case, T, softcap):
    """Kernel E over an iSWA ring bank against its plain version (the JAX
    ring mask over the whole ring): rings a multiple of E's 128-slot split
    and not, rows whose window wraps the ring's end, a row with no visible
    key (valid_from past its slot), head dims 128 and 256, with and without
    the softcap: NMSE < 1e-4 on every row, two calls bit-identical."""
    from tpullm_torch.ops.flash_decode import flash_decode, flash_decode_plain

    (H, Hkv), D, ring, window, slots, vf = RING_DECODE_CASES[case]
    q, k, v, _, _, qs, pos, vfa, _ = _decode_inputs(cuda, False, B=len(slots), T=T, H=H,
                                                    Hkv=Hkv, S=ring, D=D, slots=slots,
                                                    valid_from=vf, seed=case)
    cfg = ModelConfig(n_head=H, n_head_kv=Hkv, head_dim=D, head_dim_v=D,
                      attn_logit_softcap=softcap, sliding_window=window)
    before = _cuda.COUNTS["flash_decode"]
    got = flash_decode(q, k, v, qs, pos, vfa, cfg, window, ring=ring)
    again = flash_decode(q, k, v, qs, pos, vfa, cfg, window, ring=ring)
    torch.cuda.synchronize()
    assert _cuda.COUNTS["flash_decode"] == before + 2
    assert torch.equal(got, again)
    for b in range(len(slots)):
        sl = slice(b, b + 1)
        want = flash_decode_plain(q[sl], k[sl], v[sl], qs[sl], pos[sl], vfa[sl], D ** -0.5,
                                  softcap, window, ring=ring)
        if qs[b, -1] < vf[b]:
            assert torch.count_nonzero(got[sl]) == 0 and torch.count_nonzero(want) == 0
        else:
            assert _nmse(got[sl], want) < 1e-4, b


# (heads, D, B, T, ring, window, first slots, valid_from): the ring server's
# last chunk of a 12000-token prompt over Gemma-2-9B's ring; a 128-key tile
# that crosses the end of a 320-slot ring (2 boxes); a partial query tile
# (T = 40) and a full one over a small ring, left padding in a row
RING_PREFILL_CASES = [
    ((4, 2), 256, 1, 512, 4608, 4096, (11488,), (0,)),
    ((4, 2), 128, 1, 512, 4608, 4096, (11488,), (0,)),
    ((8, 2), 128, 2, 128, 320, 192, (1000, 400), (0, 350)),
    ((4, 4), 256, 2, 64, 192, 128, (300, 129), (0, 5)),
    ((6, 2), 128, 2, 40, 192, 128, (1000, 77), (0, 60)),
    ((16, 8), 256, 2, 40, 192, 128, (1000, 77), (0, 60)),
]


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("case", range(len(RING_PREFILL_CASES)))
def test_flash_attention_kernel_ring(cuda, case, softcap):
    """Kernel C over an iSWA ring bank (a prefill chunk of T <= ring -
    window rows) against the masked softmax with the ring mask, at head
    dims 128 and 256: NMSE < 1e-4 over rows with a visible key, rows with
    none exactly 0 in both, two calls bit-identical, one launch a call."""
    (H, Hkv), D, B, T, ring, window, first, vf = RING_PREFILL_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(case)
    q = torch.randn((B, T, H, D), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((B, Hkv, ring, D), generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn((B, Hkv, ring, D), generator=g, device=cuda).to(torch.bfloat16)
    vft = torch.tensor(vf, device=cuda)
    qs = torch.tensor(first, device=cuda)[:, None] + torch.arange(T, device=cuda)[None]
    pos = qs - vft[:, None]
    kvp = torch.zeros((B, ring), dtype=torch.int64, device=cuda)  # not read on a ring
    cfg = ModelConfig(n_head=H, n_head_kv=Hkv, head_dim=D, head_dim_v=D,
                      attn_logit_softcap=softcap, sliding_window=window)
    before = _cuda.COUNTS["flash_attention"]
    got = flash_attention(q, k, v, qs, kvp, pos, vft, cfg, True, ring)
    again = flash_attention(q, k, v, qs, kvp, pos, vft, cfg, True, ring)
    want = masked_attention(q, k, v, qs, kvp, pos, vft, D ** -0.5, softcap, window, ring)
    torch.cuda.synchronize()
    assert _cuda.COUNTS["flash_attention"] == before + 2
    assert torch.equal(got, again)
    for b, f in enumerate(vf):
        live = qs[b] >= f
        assert torch.count_nonzero(got[b, ~live]) == 0
        assert _nmse(got[b, live], want[b, live]) < 1e-4


@pytest.mark.parametrize("flag", [None, "1"])
def test_ring_engine_graph_matches_eager(cuda, monkeypatch, flag):
    """The iSWA engine on the card (a 2-layer gemma2 at head dim 256, layer
    0 on a ring of window 64 + prefill_chunk 64): its decode step as a
    replayed CUDA graph against the same step run eagerly, 129 steps that
    wrap the ring, identical greedy tokens, first logits and launch counts;
    every ring-layer call goes to a kernel (E in decode with the flag, C
    otherwise; C in the chunked prefill), none to the einsum path; the
    counters read zero after."""
    from unittest import mock

    import tpullm_torch.models.llama as llama
    from tpullm_torch.runtime.engine import InferenceEngine
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    if flag:
        monkeypatch.setenv("TPULLM_FLASH_DECODE", flag)
    else:
        monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
    cfg, params = synth_kmajor_q4k_fast(
        arch="gemma2", vocab_size=512, n_embd=512, n_layer=2, n_head=4, n_head_kv=2,
        head_dim=256, n_ff=1024, seed=3, centred=True, device="cuda", exact_vocab=True,
        tied=True, cfg_fields=dict(sliding_window=64))
    routes = []
    real = llama.attention_route

    def counted(*a):
        r = real(*a)
        routes.append((a[2], a[9] if len(a) > 9 else 0, r))  # (T, ring, route)
        return r

    res, counts, engines = {}, {}, {}
    with mock.patch.object(llama, "attention_route", counted):
        for graphs in (True, False):
            eng = engines[graphs] = InferenceEngine(cfg, params, max_seq_len=384,
                                                    decode_chunk=24, iswa=True,
                                                    prefill_chunk=64, cuda_graphs=graphs)
            _cuda.reset_counts()
            res[graphs] = eng.generate(ENGINE_PROMPTS, max_new_tokens=129, return_logits=True)
            counts[graphs] = dict(_cuda.COUNTS)
    assert engines[True].states[3].cache.ring == 128
    assert res[True].tokens == res[False].tokens
    assert (res[True].logits == res[False].logits).all()
    assert counts[True] == counts[False], counts
    ring_routes = {(T > 1, r) for T, ring, r in routes if ring}
    assert ring_routes == {(True, "flash_attention"),
                           (False, "flash_decode" if flag else "flash_attention")}, ring_routes
    assert len(engines[True].graphs) == 1
    assert _counters_zero(*engines.values())


# ------------------------------------------------ the layernorm slice's shapes

@pytest.mark.parametrize("T,n_past,S,S_full,valid_from", [
    (512, 0, 1024, 1024, (0, 212)), (512, 5632, 8192, 8192, (0,))],
    ids=["engine", "server-deep"])
def test_layernorm_heads_flash_attention_g1(cuda, T, n_past, S, S_full, valid_from):
    """Kernel C at Command-R's heads: 64 query heads over 64 kv heads of
    128 (a GQA group of 1, so each K/V tile serves one query head), at the
    engine's prefill (T 512 from slot 0, valid_from 0 and 212) and the
    server's last chunk of a 6000-token prompt (query slots 5632-6143 over
    an 8192-slot view): NMSE < 1e-4 against the masked softmax over rows
    with a visible key, rows with none exactly 0, two calls bit-identical."""
    q, k, v, qs, kvp, pos, vf = _attn_inputs(cuda, 64, 64, T, S, S_full, valid_from, n_past)
    cfg = ModelConfig(n_head=64, n_head_kv=64, head_dim=128, head_dim_v=128)
    got = flash_attention(q, k, v, qs, kvp, pos, vf, cfg)
    again = flash_attention(q, k, v, qs, kvp, pos, vf, cfg)
    want = masked_attention(q, k, v, qs, kvp, pos, vf, 1.0 / 128 ** 0.5, 0.0, 0)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for b, f in enumerate(vf.tolist()):
        live = qs[b] >= f
        assert torch.count_nonzero(got[b, ~live]) == 0
        assert _nmse(got[b, live], want[b, live]) < 1e-4


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("S,slots,valid_from", [
    (8192, (6000, 2000, 700, 40), (0, 0, 0, 0)), (1024, (527,) * 4, (0, 212, 312, 412))],
    ids=["server", "engine"])
def test_layernorm_heads_flash_decode_g1(cuda, monkeypatch, q8, S, slots, valid_from):
    """Kernel E at Command-R's heads, 64 over 64 kv heads of 128 (one query
    row a kv head in E's 16-row mma tile): the server's step (rows at
    6000/2000/700/40 of 8192) and the engine's (1024-slot view, rows at
    527), bf16 and int8, NMSE < 1e-4 against the plain version, two calls
    bit-identical."""
    from tpullm_torch.models.llama import attention_route
    from tpullm_torch.ops.flash_decode import flash_decode, flash_decode_plain

    q, k, v, ks, vs, qs, pos, vf, _ = _decode_inputs(cuda, q8, B=4, T=1, H=64, Hkv=64, S=S,
                                                     slots=slots, valid_from=valid_from)
    cfg = ModelConfig(n_head=64, n_head_kv=64, head_dim=128, head_dim_v=128)
    monkeypatch.setenv("TPULLM_FLASH_DECODE", "1")
    kv_dtype = torch.int8 if q8 else torch.bfloat16
    assert attention_route(True, 4, 1, S, 128, 128, 64, 64, kv_dtype) == "flash_decode"
    got = flash_decode(q, k, v, qs, pos, vf, cfg, k_scales=ks, v_scales=vs)
    again = flash_decode(q, k, v, qs, pos, vf, cfg, k_scales=ks, v_scales=vs)
    want = flash_decode_plain(q, k, v, qs, pos, vf, 128 ** -0.5, 0.0, 0, False, None, ks, vs)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _nmse(got, want) < 1e-4


@pytest.mark.parametrize("flag", [None, "1"])
@pytest.mark.parametrize("arch", ["command-r", "starcoder2"])
def test_layernorm_engine_on_card_matches_cpu(cuda, monkeypatch, arch, flag):
    """The layernorm slice on the card: a 2-layer command-r synth (layernorm
    without bias, the parallel block off the attention's norm, gated silu,
    logit_scale 0.0625, tied embeddings; 8/8 heads of 128, G = 1) and a
    2-layer starcoder2 synth (layernorm with biases, q/k/v biases, bo, the
    ungated gelu FFN with its biases; 12/2 heads of 128), each with a
    500-row vocab, through the engine on the card against the plain path
    on the CPU in f32, within 4x the plain bf16 error; A, B, C and the
    store launched (E with the flag), D never; then the same requests with
    cuda_graphs=False give the graph's greedy tokens and launch counts."""
    import numpy as np

    from tpullm_torch.runtime.engine import InferenceEngine
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    if flag:
        monkeypatch.setenv("TPULLM_FLASH_DECODE", flag)
    else:
        monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
    if arch == "command-r":
        spec = dict(n_embd=1024, n_head=8, n_head_kv=8, n_ff=2816, tied=True,
                    rope_base=8e6, cfg_fields=dict(norm_eps=1e-5, logit_scale=0.0625))
    else:
        spec = dict(n_embd=1536, n_head=12, n_head_kv=2, n_ff=6144,
                    rope_base=1e5, cfg_fields=dict(norm_eps=1e-5))
    cfg, params = synth_kmajor_q4k_fast(vocab_size=500, n_layer=2, seed=3, centred=True,
                                        device="cpu", arch=arch, exact_vocab=True, **spec)
    card = {k: (v.to("cuda") if not isinstance(v, dict) else
                {n: t.to("cuda") for n, t in v.items()}) for k, v in params.items()}
    if cfg.tie_embeddings:
        card["output"] = card["tok_embd"]
    prompts = [list(range(1, 101)), list(range(7, 67)), list(range(40, 70))]
    logits, counts = {}, {}
    for name, p, dev, dt in (("card", card, "cuda", torch.bfloat16),
                             ("card_eager", card, "cuda", torch.bfloat16),
                             ("cpu", params, "cpu", torch.float32),
                             ("cpu_bf16", params, "cpu", torch.bfloat16)):
        _cuda.reset_counts()
        eng = InferenceEngine(cfg, p, max_seq_len=256, compute_dtype=dt, decode_chunk=4,
                              device=dev, cuda_graphs=name != "card_eager")
        r = eng.generate(prompts, max_new_tokens=9, return_logits=True)
        counts[name] = dict(_cuda.COUNTS)
        logits[name] = (torch.from_numpy(np.asarray(r.logits)), r.tokens)
    c = counts["card"]
    assert logits["card"][0].shape[-1] == 500
    for k in ("qmm_splitk", "qmm", "flash_attention", "kv_store"):
        assert c[k] > 0, (k, c)
    assert c["layer_kernel"] == 0 and (c["flash_decode"] > 0) == bool(flag), c
    assert logits["card_eager"][1] == logits["card"][1] and counts["card_eager"] == c
    ref = _nmse(logits["cpu_bf16"][0], logits["cpu"][0])
    assert _nmse(logits["card"][0], logits["cpu"][0]) < 4 * ref
    top2 = torch.topk(logits["cpu"][0], 2, dim=-1).values
    for b, gap in enumerate((top2[:, 0] - top2[:, 1]).tolist()):
        if gap > 0.05:
            assert logits["card"][1][b][0] == logits["cpu"][1][b][0]


@pytest.mark.parametrize("qtype", sorted(KM_SPECS, key=lambda t: t.name))
def test_dequant_on_card_equals_cpu(cuda, qtype):
    """dequant_kmajor_torch gives the same f32 bits on the card as on the
    CPU for every K-major type (exact f32 products and sums, one op at a
    time), stacked and flat: chip_smoke.py's plain CPU copy dequantizes on
    the card and copies the weights to the host."""
    from tpullm_torch.ops.qtensor import QTensor

    g = torch.Generator(device=cuda).manual_seed(5)
    qt = random_kmajor(qtype, [300, 200], 1024, (2,), g, cuda)
    on_card = qt.dequant(torch.float32).cpu()
    on_cpu = qt.to("cpu").dequant(torch.float32)
    assert on_card.dtype == on_cpu.dtype == torch.float32
    assert torch.equal(on_card, on_cpu)
    flat = QTensor(qt.qtype, qt.shape[1:], {k: v[1] for k, v in qt.data.items()})
    assert torch.equal(flat.dequant(torch.float32).cpu(), flat.to("cpu").dequant(torch.float32))


def _mla_card(**kw):
    """A small MLA MoE model (synth_mla_q4k on the CPU): 3 layers over a
    512-wide stream, 4 heads, kv_lora 256 + rope 64 (K rows of 320, V of
    256), q_lora 128, layer 0 dense, 8 experts of 352 (planar Q8_0 down, as
    DeepSeek-V2-Lite's at 1408) top-2 with a shared expert of 512, YaRN."""
    from tpullm_torch.utils.synth import synth_mla_q4k

    base = dict(vocab_size=500, n_embd=512, n_layer=3, n_head=4, kv_lora_rank=256,
                qk_nope=64, qk_rope=64, v_head=64, n_ff=1024, q_lora_rank=128, n_expert=8,
                n_expert_used=2, n_ff_exp=352, n_ff_shexp=512, n_expert_shared=2,
                n_dense_lead=1, seed=3, device="cpu",
                cfg_fields=dict(n_ctx_train=163840, rope_scaling="yarn", rope_scale=40.0,
                                rope_orig_ctx=4096, rope_yarn_log_mul=0.707))
    base.update(kw)
    return synth_mla_q4k(**base)


@pytest.mark.parametrize("kv", ["bf16", "q8"])
def test_mla_engine_on_card_matches_cpu(cuda, monkeypatch, kv):
    """The MLA MoE model: the engine on the card against the plain path on
    the CPU (test_engine_on_card_matches_cpu's rule), on the bf16 and the
    int8 cache; A, B and the store launch, C, D, E, F and the skip do not
    (MLA attention takes the einsum path, D's gate refuses MLA, the planar
    down experts take the loop); the same requests with cuda_graphs=False
    give the graph's tokens and launch counts."""
    import numpy as np

    from tpullm_torch.runtime.engine import InferenceEngine

    monkeypatch.setenv("TPULLM_FLASH_DECODE", "1")  # E stays off MLA all the same
    cfg, params = _mla_card()
    card = _to(params, "cuda")
    logits, counts = {}, {}
    for name, p, dev, dt in (("card", card, "cuda", torch.bfloat16),
                             ("card_eager", card, "cuda", torch.bfloat16),
                             ("cpu", params, "cpu", torch.float32),
                             ("cpu_bf16", params, "cpu", torch.bfloat16)):
        _cuda.reset_counts()
        eng = InferenceEngine(cfg, p, max_seq_len=256, compute_dtype=dt,
                              kv_dtype="q8" if kv == "q8" else dt, decode_chunk=4,
                              device=dev, cuda_graphs=name != "card_eager")
        r = eng.generate(ENGINE_PROMPTS, max_new_tokens=9, return_logits=True)
        counts[name] = dict(_cuda.COUNTS)
        logits[name] = (torch.from_numpy(np.asarray(r.logits)), r.tokens)
    c = counts["card"]
    assert all(c[k] > 0 for k in ("qmm_splitk", "qmm", "kv_store")), c
    assert not any(c[k] for k in ("layer_kernel", "flash_attention", "flash_decode", "moe_gmm",
                                  "qmm_experts")), c
    assert logits["card_eager"][1] == logits["card"][1] and counts["card_eager"] == c
    ref = _nmse(logits["cpu_bf16"][0], logits["cpu"][0])
    assert _nmse(logits["card"][0], logits["cpu"][0]) < 4 * ref


def test_mla_server_graph_matches_eager(cuda):
    """The MLA model's server decode chunk (int8 cache, 2 slots at other
    depths) as graph replays and as eager steps from the same state: the
    same tokens and launch counts."""
    import numpy as np

    from tpullm_torch.server.context import GenParams, ServerContext, Task

    cfg, params = _mla_card(device="cuda")
    ctx = ServerContext(cfg, params, None, n_slots=2, max_seq_len=256, decode_chunk=4,
                        prefill_chunk=64, kv_dtype="q8")
    for pr in ENGINE_PROMPTS[:2]:
        ctx.submit(Task(tokens=pr, params=GenParams(max_tokens=100, temperature=0.0,
                                                    ignore_eos=True)))
    with torch.inference_mode():
        ctx._admit()
        while any(r.pending for r in ctx.rt):
            for i, r in enumerate(ctx.rt):
                if r.pending:
                    ctx._prefill_step(i)
        st, pen, cache = ctx.state, ctx.penalties, ctx.memory.cache
        live = [t for t in (cache.k, cache.v, cache.ks, cache.vs, st.logits, st.ctl, st.mu,
                            st.toks, pen.counts, pen.ring, pen.pos) if t is not None]
        saved = [t.clone() for t in live]
        res = {}
        for way in ("graph", "eager"):
            ctx.cuda_graphs = way == "graph"
            for t, c in zip(live, saved):
                t.copy_(c)
            ctx._gen.manual_seed(ctx._seed)
            _cuda.reset_counts()
            toks = ctx._decode(4, ctx._kv_view_bucket(4), False)[0]
            res[way] = (np.asarray(toks), dict(_cuda.COUNTS))
    ctx.stop()
    (tg, cg), (te, ce) = res["graph"], res["eager"]
    assert np.array_equal(tg, te) and cg == ce, (tg, te, cg, ce)
    assert cg["kv_store"] > 0 and cg["qmm_splitk"] > 0 and cg["flash_decode"] == 0


@pytest.mark.parametrize("M", [1, 4, 16])
def test_layer_kernel_phi4_combined_gateup(cuda, M):
    """Kernel D at Phi-4's layer (5120 wide, 40/10 heads of 128, n_ff
    17920; K 5120 and 17920 keep Q4_K's 32-group f32 d/dmin) on the GGUF's
    combined [gate; up], an ffn_up of 2 x 17920 rows that the loader's fuse
    step renames ffn_gateup, plain and folded against its plain version."""
    from tpullm_torch.ops.fuse import fuse_layer_weights

    D, H, Hkv, n_ff, L, hd = 5120, 40, 10, 17920, 2, 128
    g = torch.Generator(device=cuda).manual_seed(2323 + M)
    cfg = ModelConfig(arch="phi3", n_embd=D, n_layer=L, n_head=H, n_head_kv=Hkv, head_dim=hd,
                      head_dim_v=hd, n_ff=n_ff)
    q = GGMLType.Q4_K
    up = random_kmajor(q, [2 * n_ff], D, (L,), g, cuda)
    layers = fuse_layer_weights({"ffn_up": up}, cfg)
    assert set(layers) == {"ffn_gateup"} and layers["ffn_gateup"] is up
    qw = {"wo": random_kmajor(q, [D], H * hd, (L,), g, cuda), "ffn_gateup": up,
          "ffn_down": random_kmajor(q, [D], n_ff, (L,), g, cuda),
          "wqkv": random_kmajor(q, [H * hd, Hkv * hd, Hkv * hd], D, (L,), g, cuda)}
    norms = 1 + 0.1 * torch.randn((2, L, D), generator=g, device=cuda)
    _check_layer(qw, cfg, norms, g, M, 1)


@pytest.mark.parametrize("flag", [None, "1"])
def test_phi3_engine_on_card_matches_cpu(cuda, monkeypatch, flag):
    """A 2-layer phi3 model as its file lays it out (the fused attn_qkv as
    wqkv_cat, the combined ffn_up renamed ffn_gateup by the loader's fuse
    step; 1024 wide, 8/2 heads of 128, n_ff 3072, a 500-row vocab) through
    the engine on the card against the plain path on the CPU in f32, within
    4x the plain bf16 error: A, B, C, D and the store launched (E with the
    flag), F not; then the same requests with cuda_graphs=False give the
    graph's greedy tokens and launch counts."""
    import numpy as np

    from tpullm_torch.runtime.engine import InferenceEngine
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    if flag:
        monkeypatch.setenv("TPULLM_FLASH_DECODE", flag)
    else:
        monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
    cfg, params = synth_kmajor_q4k_fast(arch="phi3", vocab_size=500, n_embd=1024, n_layer=2,
                                        n_head=8, n_head_kv=2, n_ff=3072, seed=3, centred=True,
                                        device="cpu", exact_vocab=True, rope_base=2.5e5,
                                        gguf_layout=True)
    assert {"wqkv_cat", "ffn_gateup"} <= set(params["layers"])
    card = {k: (v.to("cuda") if not isinstance(v, dict) else
                {n: t.to("cuda") for n, t in v.items()}) for k, v in params.items()}
    logits, counts = {}, {}
    for name, p, dev, dt in (("card", card, "cuda", torch.bfloat16),
                             ("card_eager", card, "cuda", torch.bfloat16),
                             ("cpu", params, "cpu", torch.float32),
                             ("cpu_bf16", params, "cpu", torch.bfloat16)):
        _cuda.reset_counts()
        eng = InferenceEngine(cfg, p, max_seq_len=256, compute_dtype=dt, decode_chunk=4,
                              device=dev, cuda_graphs=name != "card_eager")
        r = eng.generate(ENGINE_PROMPTS, max_new_tokens=9, return_logits=True)
        counts[name] = dict(_cuda.COUNTS)
        logits[name] = (torch.from_numpy(np.asarray(r.logits)), r.tokens)
    c = counts["card"]
    assert logits["card"][0].shape[-1] == 500
    for k in ("qmm_splitk", "qmm", "flash_attention", "layer_kernel", "kv_store"):
        assert c[k] > 0, (k, c)
    assert c["moe_gmm"] == 0 and (c["flash_decode"] > 0) == bool(flag), c
    assert logits["card_eager"][1] == logits["card"][1] and counts["card_eager"] == c
    ref = _nmse(logits["cpu_bf16"][0], logits["cpu"][0])
    assert _nmse(logits["card"][0], logits["cpu"][0]) < 4 * ref
    top2 = torch.topk(logits["cpu"][0], 2, dim=-1).values
    for b, gap in enumerate((top2[:, 0] - top2[:, 1]).tolist()):
        if gap > 0.05:
            assert logits["card"][1][b][0] == logits["cpu"][1][b][0]


@pytest.mark.parametrize("kind", ["bf16", "int8", "ring"])
@pytest.mark.parametrize("T", [1, 8])
def test_flash_decode_kernel_head_dim_64_sinks(cuda, kind, T):
    """Kernel E at head dim 64 (gpt-oss's; 16/2 heads here, a GQA group of
    8, so 8 or 64 query rows a kv head) with sinks and a window of 128,
    against its plain version: bf16 and int8 on a 1024-slot view, bf16 on a
    200-slot ring whose windows wrap its end; NMSE < 1e-4, two calls
    bit-identical, two launches. At T = 1 the last row (slot 5, valid_from
    7) sees no key and outputs 0, its sink notwithstanding."""
    from tpullm_torch.ops.flash_decode import flash_decode, flash_decode_plain

    ring = 200 if kind == "ring" else 0
    q8 = kind == "int8"
    slots, vf = ((700, 450, 199, 10), (0, 3, 0, 12)) if ring else ((900, 300, 40, 5),
                                                                    (0, 3, 1, 7))
    q, k, v, ks, vs, qs, pos, vfa, g = _decode_inputs(cuda, q8, B=4, T=T, H=16, Hkv=2,
                                                      S=ring or 1024, D=64, slots=slots,
                                                      valid_from=vf, seed=T)
    cfg = ModelConfig(n_head=16, n_head_kv=2, head_dim=64, head_dim_v=64, sliding_window=128)
    sinks = torch.randn(16, generator=g, device=cuda) * 2.0
    before = _cuda.COUNTS["flash_decode"]
    a = flash_decode(q, k, v, qs, pos, vfa, cfg, 128, sinks, k_scales=ks, v_scales=vs,
                     ring=ring)
    b = flash_decode(q, k, v, qs, pos, vfa, cfg, 128, sinks, k_scales=ks, v_scales=vs,
                     ring=ring)
    want = flash_decode_plain(q, k, v, qs, pos, vfa, 64 ** -0.5, 0.0, 128, False, sinks, ks, vs,
                              ring=ring)
    torch.cuda.synchronize()
    assert _cuda.COUNTS["flash_decode"] == before + 2
    assert torch.equal(a, b) and a.shape == want.shape == (4, T, 16, 64)
    if T == 1 and not ring:
        assert torch.count_nonzero(a[3]) == 0 and torch.count_nonzero(want[3]) == 0
    assert _nmse(a, want) < 1e-4


def test_gptoss_engine_on_card_matches_cpu(cuda, monkeypatch):
    """A 2-layer gpt-oss model at gpt-oss-20b's K 2880 (planar MXFP4
    experts with their biases and the router's bias, planar Q8_0 q/k/v,
    embedding and lm_head, K-major wo; 8/2 heads of 64 with sinks, the SWA
    array (1, 0) with a window of 32, YaRN) through the engine on the card
    with TPULLM_FLASH_DECODE=1 against the plain path on the CPU in f32,
    within 4x the plain bf16 error: A, B, E and the store launched; C (the
    sinks), D, F and the skip (the biased stack takes the loop) not; the
    same requests with cuda_graphs=False give the graph's greedy tokens and
    launch counts; the iSWA ring engine (E on its ring, C never) is within
    the same bound of the CPU."""
    import numpy as np

    from tpullm_torch.runtime.engine import InferenceEngine
    from tpullm_torch.utils.synth import synth_gptoss

    monkeypatch.setenv("TPULLM_FLASH_DECODE", "1")
    cfg, params = synth_gptoss(vocab_size=500, n_embd=2880, n_layer=2, n_head=8, n_head_kv=2,
                               head_dim=64, n_expert=4, n_expert_used=2, n_ff_exp=2880,
                               sliding_window=32, swa_layer_pattern=(1, 0), seed=5, device="cpu",
                               cfg_fields=dict(rope_scaling="yarn", rope_scale=32.0,
                                               rope_orig_ctx=4096, n_ctx_train=131072,
                                               expert_weights_norm=True))
    lay = params["layers"]
    assert lay["moe_gate_exps"].layout == lay["wq"].layout == params["output"].layout == "planar"

    def to(v, dev):
        return {n: to(t, dev) for n, t in v.items()} if isinstance(v, dict) else v.to(dev)

    card = to(params, "cuda")
    logits, counts = {}, {}
    for name, p, dev, dt, kw in (("card", card, "cuda", torch.bfloat16, {}),
                                 ("card_eager", card, "cuda", torch.bfloat16,
                                  dict(cuda_graphs=False)),
                                 ("card_ring", card, "cuda", torch.bfloat16,
                                  dict(iswa=True, prefill_chunk=64)),
                                 ("cpu", params, "cpu", torch.float32, {}),
                                 ("cpu_bf16", params, "cpu", torch.bfloat16, {})):
        _cuda.reset_counts()
        eng = InferenceEngine(cfg, p, max_seq_len=256, compute_dtype=dt, decode_chunk=4,
                              device=dev, **kw)
        r = eng.generate(ENGINE_PROMPTS, max_new_tokens=9, return_logits=True)
        counts[name] = dict(_cuda.COUNTS)
        logits[name] = (torch.from_numpy(np.asarray(r.logits)), r.tokens)
    c = counts["card"]
    for k in ("qmm_splitk", "qmm", "flash_decode", "kv_store"):
        assert c[k] > 0, (k, c)
    for k in ("flash_attention", "layer_kernel", "moe_gmm", "qmm_experts"):
        assert c[k] == 0, (k, c)
    assert logits["card_eager"][1] == logits["card"][1] and counts["card_eager"] == c
    assert counts["card_ring"]["flash_decode"] > 0 and counts["card_ring"]["flash_attention"] == 0
    ref = _nmse(logits["cpu_bf16"][0], logits["cpu"][0])
    assert _nmse(logits["card"][0], logits["cpu"][0]) < 4 * ref
    assert _nmse(logits["card_ring"][0], logits["cpu"][0]) < 4 * ref


# ------------------------------------------ the iRoPE decoders (llama4)

@pytest.mark.parametrize("heads", [(4, 4), (10, 2), (8, 1)], ids=["G1", "G5", "G8"])
@pytest.mark.parametrize("window", [64, 128, 8192])
@pytest.mark.parametrize("T,n_past,S,S_full", [
    (128, 0, 256, 256), (512, 1000, 2048, 2560), (512, 8000, 16384, 16384),
    (192, 128, 320, 448)],
    ids=["T128", "T512-deep", "T512-8000", "T192-odd"])
def test_flash_attention_kernel_chunked(cuda, heads, window, T, n_past, S, S_full):
    """Kernel C with llama4's chunked window against its plain version
    (masked_attention(..., chunked=True)), valid_from 0, 37 and 100: blocks
    at a chunk's start, straddling one (a 512-row block from slot 1000 over
    windows of 64 and 128; rows 8000-8511 over the 8192 boundary of a
    16384-slot view) and wholly past one: NMSE < 1e-4 over rows with a
    visible key, the rows with none exactly 0, two calls identical. The
    chunk moves the output from the sliding window's where the block
    straddles a boundary."""
    H, Hkv = heads
    q, k, v, qs, kvp, pos, vf = _attn_inputs(cuda, H, Hkv, T, S, S_full, (0, 37, 100), n_past)
    cfg = ModelConfig(n_head=H, n_head_kv=Hkv, head_dim=128, head_dim_v=128,
                      sliding_window=window, swa_chunked=True)
    before = _cuda.COUNTS["flash_attention"]
    got = flash_attention(q, k, v, qs, kvp, pos, vf, cfg, layer_is_swa=True)
    again = flash_attention(q, k, v, qs, kvp, pos, vf, cfg, layer_is_swa=True)
    want = masked_attention(q, k, v, qs, kvp, pos, vf, 1.0 / 128 ** 0.5, 0.0, window,
                            chunked=True)
    torch.cuda.synchronize()
    assert _cuda.COUNTS["flash_attention"] == before + 2
    assert torch.equal(got, again)
    for b, f in enumerate(vf.tolist()):
        live = qs[b] >= f
        assert torch.count_nonzero(got[b, ~live]) == 0
        assert _nmse(got[b, live], want[b, live]) < 1e-4
    live = qs >= vf[:, None]  # a left-padding row's position is negative: no chunk of its own
    straddles = any(int(p[l].min()) // window != int(p[l].max()) // window
                    for p, l in zip(pos, live))
    if straddles:
        sliding = masked_attention(q, k, v, qs, kvp, pos, vf, 1.0 / 128 ** 0.5, 0.0, window)
        assert _nmse(sliding, want) > 1e-4


def test_flash_attention_kernel_chunked_head_dim_256(cuda):
    """C's head-dim-256 instance with the chunked mask, a 512-row block
    straddling a chunk boundary of 128: NMSE < 1e-4 against the plain
    version."""
    q, k, v, qs, kvp, pos, vf = _attn_inputs(cuda, 8, 4, 512, 2048, 2560, (0, 37), 1000, D=256)
    cfg = ModelConfig(n_head=8, n_head_kv=4, head_dim=256, head_dim_v=256, sliding_window=128,
                      swa_chunked=True)
    got = flash_attention(q, k, v, qs, kvp, pos, vf, cfg, layer_is_swa=True)
    want = masked_attention(q, k, v, qs, kvp, pos, vf, 1.0 / 256 ** 0.5, 0.0, 128, chunked=True)
    assert _nmse(got, want) < 1e-4


@pytest.mark.parametrize("flag", [None, "1"], ids=["E_off", "E_on"])
def test_llama4_engine_on_card_matches_cpu(cuda, monkeypatch, flag):
    """A 4-layer llama4 model (synth_moe_q4k: 4 heads of 128 over 2 kv
    heads, 4 experts of 512 top-1 by sigmoid, an ungated shared expert of
    512; chunks of 64, layer 3 NoPE with the temperature floor cut to 8,
    the L2 QK norm): the engine on the card against the plain path on the
    CPU in f32, within 4x the plain bf16 error, with the 100-token prompt's
    prefill straddling the chunk boundary at 64 in C (chunked) and its
    decode steps at temperatures above 1: A, B, C, F, the skip and the
    store launched, D not (E with TPULLM_FLASH_DECODE=1, chunked); the same
    requests with cuda_graphs=False give the graph's tokens and launch
    counts, so the NoPE layer and the temperature ride inside the captured
    step."""
    import numpy as np

    from tpullm_torch.models.llama import nope_flags
    from tpullm_torch.runtime.engine import InferenceEngine
    from tpullm_torch.utils.synth import synth_moe_q4k

    if flag:
        monkeypatch.setenv("TPULLM_FLASH_DECODE", flag)
    else:
        monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
    cfg, params = synth_moe_q4k(arch="llama4", vocab_size=500, n_embd=512, n_layer=4,
                                n_head=4, n_head_kv=2, head_dim=128, n_ff=1024, n_expert=4,
                                n_expert_used=1, n_ff_exp=512, n_ff_shexp=512, shexp_gate=False,
                                rope_base=5e5, exact_vocab=True, seed=3, device="cpu",
                                cfg_fields=dict(sliding_window=64, attn_temp_floor=8))
    assert nope_flags(cfg) == [False, False, False, True] and cfg.swa_chunked
    card = _to(params, "cuda")
    logits, counts = {}, {}
    for name, p, dev, dt in (("card", card, "cuda", torch.bfloat16),
                             ("card_eager", card, "cuda", torch.bfloat16),
                             ("cpu", params, "cpu", torch.float32),
                             ("cpu_bf16", params, "cpu", torch.bfloat16)):
        _cuda.reset_counts()
        eng = InferenceEngine(cfg, p, max_seq_len=256, compute_dtype=dt, decode_chunk=4,
                              device=dev, cuda_graphs=name != "card_eager")
        r = eng.generate(ENGINE_PROMPTS, max_new_tokens=9, return_logits=True)
        counts[name] = dict(_cuda.COUNTS)
        logits[name] = (torch.from_numpy(np.asarray(r.logits)), r.tokens)
    c = counts["card"]
    for k in ("qmm_splitk", "qmm", "flash_attention", "moe_gmm", "qmm_experts", "kv_store"):
        assert c[k] > 0, (k, c)
    assert c["layer_kernel"] == 0 and (c["flash_decode"] > 0) == bool(flag), c
    assert logits["card_eager"][1] == logits["card"][1] and counts["card_eager"] == c
    ref = _nmse(logits["cpu_bf16"][0], logits["cpu"][0])
    assert _nmse(logits["card"][0], logits["cpu"][0]) < 4 * ref


# -------------------- the other MoE families (grok, arctic, dbrx, grovemoe)

def _moe_stacks(cuda, g, E, n_ff, D, qtype=GGMLType.Q4_K, down_qtype=None, L=2):
    """(L, E) K-major gate, up and down stacks of qtype, drawn on the card
    (n_ff wide, K D; down D wide, K n_ff), as the loader stacks them."""
    from tpullm_torch.ops.qtensor import QTensor

    def stack(qt, n, K):
        w = random_kmajor(qt, [n], K, (L, E), g, cuda)
        return QTensor(qt, (L, E, n, K), w.data)

    return (stack(qtype, n_ff, D), stack(qtype, n_ff, D), stack(down_qtype or qtype, D, n_ff))


@pytest.mark.parametrize("M", [4, 16, 200])
def test_moe_gelu_experts_skip_and_ragged_vs_loop(cuda, monkeypatch, M):
    """grok's GELU experts through the skip (M <= 16: bit for bit the loop,
    three skip launches) and kernel F (M = 200: within bf16's rounding of the
    loop, NMSE < 1e-4, F launched), the activation applied outside the
    kernels; silu gives another output."""
    import tpullm_torch.models.llama as llama
    from tpullm_torch.models.llama import moe_ffn
    from tpullm_torch.ops.qtensor import QTensor

    g = torch.Generator(device=cuda).manual_seed(26)
    E, D, n_ff = 8, 512, 512
    gate, up, down = _moe_stacks(cuda, g, E, n_ff, D)
    router = QTensor(GGMLType.F32, (2, E, D), {"w": torch.randn((2, E, D), generator=g,
                                                               device=cuda) * 0.1})
    qw = {"moe_gate_inp": router, "moe_gate_exps": gate, "moe_up_exps": up,
          "moe_down_exps": down}
    cfg = ModelConfig(arch="grok", n_embd=D, n_expert=E, n_expert_used=2, act_fn="gelu",
                      expert_weights_norm=True)
    x = torch.randn((1, M, D), generator=g, device=cuda).to(torch.bfloat16)
    _cuda.reset_counts()
    got = moe_ffn(x, qw, 1, cfg, torch.bfloat16)
    c = dict(_cuda.COUNTS)
    route = llama.moe_route
    monkeypatch.setattr(llama, "moe_route", lambda *a, **k: "loop")
    want = moe_ffn(x, qw, 1, cfg, torch.bfloat16)
    silu = moe_ffn(x, qw, 1, dataclasses.replace(cfg, act_fn="silu"), torch.bfloat16)
    monkeypatch.setattr(llama, "moe_route", route)
    if M <= 16:
        assert c["qmm_experts"] == 3 and torch.equal(got, want), c
    else:
        assert c["moe_gmm"] == 3 and _nmse(got, want) < 1e-4, c
    assert _nmse(silu, want) > 1e-4


@pytest.mark.parametrize("M", [4, 16, 200])
def test_chunk_bank_skip_and_ragged_vs_loop(cuda, monkeypatch, M):
    """grovemoe's chunk bank on K-major Q8_0 stacks at a chunk FFN of 256 (8
    chunk experts, picks // 2 of a top-8 of 16, so rows name a chunk twice,
    and the first row on purpose): the skip (M <= 16) bit for bit the loop
    over every chunk, its combine summing a chunk's two weights; kernel F
    (M = 200) within bf16's rounding of the loop (NMSE < 1e-4) and at NMSE <
    1e-8 (the bf16 output's last bits) against itself with each chunk's
    weights summed onto its first naming, where keeping one of the two
    weights is off by NMSE > 1e-4."""
    import tpullm_torch.models.llama as llama
    from tpullm_torch.models.llama import _moe_prefill_ragged, chunk_bank

    g = torch.Generator(device=cuda).manual_seed(27)
    E, grp, D, n_ch = 16, 2, 512, 256
    gate, up, down = _moe_stacks(cuda, g, E // grp, n_ch, D, GGMLType.Q8_0)
    qw = {"moe_gate_chexps": gate, "moe_up_chexps": up, "moe_down_chexps": down}
    cfg = ModelConfig(arch="grovemoe", n_embd=D, n_expert=E, n_expert_used=8,
                      expert_weights_norm=True, n_group_experts=grp, expert_group_scale=0.05)
    x = torch.randn((1, M, D), generator=g, device=cuda).to(torch.bfloat16)
    probs = torch.softmax(torch.randn((1, M, E), generator=g, device=cuda), -1)
    top_i = torch.rand((1, M, E), generator=g, device=cuda).argsort(-1)[..., :8]
    top_i[0, 0, :2] = torch.tensor([4, 5], device=cuda)
    chunk_i = top_i // grp
    assert bool((chunk_i[0, 0, 0] == chunk_i[0, 0, 1]))
    _cuda.reset_counts()
    got = chunk_bank(x, probs, top_i, qw, 1, cfg, torch.bfloat16)
    c = dict(_cuda.COUNTS)
    route = llama.moe_route
    monkeypatch.setattr(llama, "moe_route", lambda *a, **k: "loop")
    want = chunk_bank(x, probs, top_i, qw, 1, cfg, torch.bfloat16)
    monkeypatch.setattr(llama, "moe_route", route)
    if M <= 16:
        assert c["qmm_experts"] == 3 and torch.equal(got, want), c
        return
    assert c["moe_gmm"] == 3 and _nmse(got, want) < 1e-4, c
    w = torch.gather(probs, -1, chunk_i)
    w = w / w.sum(-1, keepdim=True)
    later = torch.triu(chunk_i[..., :, None] == chunk_i[..., None, :], 1)
    merged = (w + (later * w[..., None, :]).sum(-1)) * (~later.any(-2))
    ccfg = dataclasses.replace(cfg, n_expert=E // grp)
    ragged = lambda wt: _moe_prefill_ragged(x, wt, chunk_i, gate, up, down, 1, ccfg,
                                            torch.bfloat16)
    assert _nmse(ragged(w), ragged(merged)) < 1e-8
    assert _nmse(ragged(w * (~later.any(-2))), ragged(w)) > 1e-4


@pytest.mark.parametrize("T,n_past,S,S_full", [(512, 0, 1024, 1024), (512, 1000, 2048, 2560)],
                         ids=["T512", "T512-deep"])
def test_flash_attention_kernel_grok_heads_softcap(cuda, T, n_past, S, S_full):
    """Kernel C at grok-1's heads (48/8 of 128) with its softcap of 30 against
    the masked softmax: NMSE < 1e-4 on rows with a visible key, the others
    exactly 0, two calls bit-identical."""
    q, k, v, qs, kvp, pos, vf = _attn_inputs(cuda, 48, 8, T, S, S_full, (0, 37, 100), n_past)
    cfg = ModelConfig(n_head=48, n_head_kv=8, head_dim=128, head_dim_v=128,
                      attn_logit_softcap=30.0)
    got = flash_attention(q, k, v, qs, kvp, pos, vf, cfg)
    assert torch.equal(got, flash_attention(q, k, v, qs, kvp, pos, vf, cfg))
    want = masked_attention(q, k, v, qs, kvp, pos, vf, 1.0 / 128 ** 0.5, 30.0, 0)
    for b, f in enumerate(vf.tolist()):
        live = qs[b] >= f
        assert torch.count_nonzero(got[b, ~live]) == 0
        assert _nmse(got[b, live], want[b, live]) < 1e-4


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("T", [1, 4])
def test_flash_decode_kernel_grok_heads_softcap(cuda, q8, T):
    """Kernel E at grok-1's heads (48/8 of 128, a GQA group of 6) with its
    softcap of 30, bf16 and int8, against its plain version: NMSE < 1e-4,
    two calls bit-identical."""
    from tpullm_torch.ops.flash_decode import flash_decode, flash_decode_plain

    q, k, v, ks, vs, qs, pos, vf, g = _decode_inputs(cuda, q8, T=T, H=48, Hkv=8)
    cfg = ModelConfig(n_head=48, n_head_kv=8, head_dim=128, head_dim_v=128,
                      attn_logit_softcap=30.0)
    a = flash_decode(q, k, v, qs, pos, vf, cfg, 0, None, k_scales=ks, v_scales=vs)
    assert torch.equal(a, flash_decode(q, k, v, qs, pos, vf, cfg, 0, None, k_scales=ks,
                                       v_scales=vs))
    want = flash_decode_plain(q, k, v, qs, pos, vf, 128 ** -0.5, 30.0, 0, False, None, ks, vs)
    assert _nmse(a, want) < 1e-4


def _family_card(arch):
    """A 2-layer model of ``arch`` at n_embd 512 (8 experts of 512, top-2,
    Q4_K K-major) on the CPU: grok's and arctic's MoE layers with a dense FFN
    of 1024 beside the experts (the fused gate/up and down), arctic's
    ffn_norm_exps; dbrx's layernorm and clamp of 8; grovemoe's chunk bank of
    4 chunk experts of 256 (Q8_0 down, K-major)."""
    from tpullm_torch.utils.synth import synth_moe_q4k

    kw = dict(vocab_size=500, n_embd=512, n_layer=2, n_head=4, n_head_kv=2, n_ff=1024,
              n_expert=8, n_expert_used=2, n_ff_exp=512, rms_eps=1e-6, exact_vocab=True,
              seed=4, device="cpu")
    if arch == "dbrx":
        kw["cfg_fields"] = dict(clamp_kqv=8.0, norm_eps=1e-5)
    if arch == "grovemoe":
        kw.update(head_dim=128, n_group_experts=2, n_ff_chexp=256, expert_group_scale=0.05)
    cfg, params = synth_moe_q4k(arch=arch, **kw)
    if arch in ("grok", "arctic"):
        g = torch.Generator().manual_seed(9)
        lay = params["layers"]
        lay["ffn_gateup"] = random_kmajor(GGMLType.Q4_K, [cfg.n_ff, cfg.n_ff], 512, (2,), g,
                                          "cpu")
        lay["ffn_down"] = random_kmajor(GGMLType.Q4_K, [512], cfg.n_ff, (2,), g, "cpu")
        if arch == "arctic":
            lay["ffn_norm_exps"] = 1.0 + 0.1 * torch.randn((2, 512), generator=g)
    return cfg, params


@pytest.mark.parametrize("flag", [None, "1"])
@pytest.mark.parametrize("arch", ["grok", "arctic", "dbrx", "grovemoe"])
def test_moe_family_engine_on_card_matches_cpu(cuda, monkeypatch, arch, flag):
    """grok (GELU experts beside a dense FFN, scaled by sqrt(2)/2; the
    attention softcap of 30, its embedding and logit scales, post-norms),
    arctic (the dense FFN plus the MoE on the layer input under
    ffn_norm_exps), dbrx (layernorm, clamp 8) and grovemoe (the chunk bank,
    K-major: the skip and F take it too) through the engine on the card
    (E off and on) against the plain path on the CPU in f32, within 4x the
    plain bf16 error: A, B, C, F, the store and the skip launched, D not;
    the same requests with cuda_graphs=False give the graph's tokens and
    launch counts."""
    import numpy as np

    from tpullm_torch.runtime.engine import InferenceEngine

    if flag:
        monkeypatch.setenv("TPULLM_FLASH_DECODE", flag)
    else:
        monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
    cfg, params = _family_card(arch)
    card = _to(params, "cuda")
    logits, counts = {}, {}
    for name, p, dev, dt in (("card", card, "cuda", torch.bfloat16),
                             ("card_eager", card, "cuda", torch.bfloat16),
                             ("cpu", params, "cpu", torch.float32),
                             ("cpu_bf16", params, "cpu", torch.bfloat16)):
        _cuda.reset_counts()
        eng = InferenceEngine(cfg, p, max_seq_len=256, compute_dtype=dt, decode_chunk=4,
                              device=dev, cuda_graphs=name != "card_eager")
        r = eng.generate(ENGINE_PROMPTS, max_new_tokens=9, return_logits=True)
        counts[name] = dict(_cuda.COUNTS)
        logits[name] = (torch.from_numpy(np.asarray(r.logits)), r.tokens)
    c = counts["card"]
    assert all(c[k] > 0 for k in ("qmm_splitk", "qmm", "flash_attention", "moe_gmm",
                                  "kv_store", "qmm_experts")), c
    assert c["layer_kernel"] == 0 and (c["flash_decode"] > 0) == bool(flag), c
    assert logits["card_eager"][1] == logits["card"][1] and counts["card_eager"] == c
    ref = _nmse(logits["cpu_bf16"][0], logits["cpu"][0])
    assert _nmse(logits["card"][0], logits["cpu"][0]) < 4 * ref


# ----------------------------------- the per-layer-embedding Gemmas (gemma3n)

@pytest.mark.parametrize("flag", [None, "1"])
def test_gemma3n_engine_on_card_matches_cpu(cuda, monkeypatch, flag):
    """A 10-layer gemma3n model (synth_gemma3n at n_embd 512, 8/2 heads of
    256, n_ff 1024, 5 owning layers: layers 5-8 read bank 3, layer 9 bank
    4; the per-layer table cut to 96 rows, so the prompts' ids past it read
    its last row on the card as on the CPU): the engine on the card against
    the plain path on the CPU in f32, within 4x the plain bf16 error; A, B,
    C and the store launched, D not (E with TPULLM_FLASH_DECODE=1); the
    same requests with cuda_graphs=False give the graph's tokens and launch
    counts, so the per-layer gather, AltUp and the shared layers ride
    inside the captured step."""
    import numpy as np

    from tpullm_torch.runtime.engine import InferenceEngine
    from tpullm_torch.utils.synth import synth_gemma3n

    if flag:
        monkeypatch.setenv("TPULLM_FLASH_DECODE", flag)
    else:
        monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
    cfg, params = synth_gemma3n(vocab_size=1024, n_embd=512, n_layer=10, n_head=8, n_head_kv=2,
                                head_dim=256, n_ff=1024, table_rows=96, n_layer_kv_from_start=5,
                                sliding_window=64, device="cpu",
                                generator=torch.Generator().manual_seed(3))
    card = _to(params, "cuda")
    logits, counts = {}, {}
    for name, p, dev, dt in (("card", card, "cuda", torch.bfloat16),
                             ("card_eager", card, "cuda", torch.bfloat16),
                             ("cpu", params, "cpu", torch.float32),
                             ("cpu_bf16", params, "cpu", torch.bfloat16)):
        _cuda.reset_counts()
        eng = InferenceEngine(cfg, p, max_seq_len=256, compute_dtype=dt, decode_chunk=4,
                              device=dev, cuda_graphs=name != "card_eager")
        r = eng.generate(ENGINE_PROMPTS, max_new_tokens=9, return_logits=True)
        counts[name] = dict(_cuda.COUNTS)
        logits[name] = (torch.from_numpy(np.asarray(r.logits)), r.tokens)
        if name == "card":
            assert eng.states[len(ENGINE_PROMPTS)].cache.k.shape[0] == 5
    c = counts["card"]
    for k in ("qmm_splitk", "qmm", "flash_attention", "kv_store"):
        assert c[k] > 0, (k, c)
    assert c["layer_kernel"] == 0 and (c["flash_decode"] > 0) == bool(flag), c
    assert logits["card_eager"][1] == logits["card"][1] and counts["card_eager"] == c
    ref = _nmse(logits["cpu_bf16"][0], logits["cpu"][0])
    assert _nmse(logits["card"][0], logits["cpu"][0]) < 4 * ref


def _dense_single(arch):
    """A 2-layer model of a dense single at kernel widths on the CPU:
    chameleon (per-head layernorm q/k norms, every weight K-major, so its
    decode takes D folded), apertus (xIELU's ungated FFN) and bitnet (planar
    TQ2_0 projections, sub-norms and scales; a K-major Q4_K tied embedding),
    1024 wide, 8/2 heads of 128, n_ff 1024, 2048 or 1536, a 500-row vocab."""
    from tpullm_torch.utils.synth import synth_dense_single, synth_kmajor_q4k_fast

    g = torch.Generator().manual_seed(5)
    common = dict(vocab_size=500, n_embd=1024, n_layer=2, n_head=8, n_head_kv=2, device="cpu",
                  generator=g)
    if arch == "apertus":
        return synth_kmajor_q4k_fast(arch=arch, n_ff=2048, exact_vocab=True, rope_base=1.2e7,
                                     centred=True, **common)
    if arch == "bitnet":
        return synth_dense_single(arch=arch, n_ff=1536, qtype=GGMLType.TQ2_0, tied=True,
                                  rope_base=5e5, **common)
    return synth_dense_single(arch=arch, n_ff=1024, **common)


@pytest.mark.parametrize("flag", [None, "1"], ids=["E_off", "E_on"])
@pytest.mark.parametrize("arch", ["chameleon", "apertus", "bitnet"])
def test_dense_single_engine_on_card_matches_cpu(cuda, monkeypatch, arch, flag):
    """The dense singles (_dense_single) through the engine on the card
    against the plain path on the CPU in f32, within 4x the plain bf16
    error: chameleon's QK norm on the rows D's folded launch emits (D
    launched), apertus's xIELU and bitnet's sub-norms and scales off D (D
    not launched); A, C and the store launched (E with the flag), F not;
    the same requests with cuda_graphs=False give the graph's greedy tokens
    and launch counts, so xIELU's parameters, the scales and the norms ride
    inside the captured step."""
    import numpy as np

    from tpullm_torch.runtime.engine import InferenceEngine

    if flag:
        monkeypatch.setenv("TPULLM_FLASH_DECODE", flag)
    else:
        monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
    cfg, params = _dense_single(arch)
    card = _to(params, "cuda")
    logits, counts = {}, {}
    for name, p, dev, dt in (("card", card, "cuda", torch.bfloat16),
                             ("card_eager", card, "cuda", torch.bfloat16),
                             ("cpu", params, "cpu", torch.float32),
                             ("cpu_bf16", params, "cpu", torch.bfloat16)):
        _cuda.reset_counts()
        eng = InferenceEngine(cfg, p, max_seq_len=256, compute_dtype=dt, decode_chunk=4,
                              device=dev, cuda_graphs=name != "card_eager")
        r = eng.generate(ENGINE_PROMPTS, max_new_tokens=9, return_logits=True)
        counts[name] = dict(_cuda.COUNTS)
        logits[name] = (torch.from_numpy(np.asarray(r.logits)), r.tokens)
    c = counts["card"]
    for k in ("qmm_splitk", "flash_attention", "kv_store"):
        assert c[k] > 0, (k, c)
    assert c["moe_gmm"] == 0 and (c["flash_decode"] > 0) == bool(flag), c
    assert (c["layer_kernel"] > 0) == (arch == "chameleon"), c
    assert logits["card_eager"][1] == logits["card"][1] and counts["card_eager"] == c
    ref = _nmse(logits["cpu_bf16"][0], logits["cpu"][0])
    assert _nmse(logits["card"][0], logits["cpu"][0]) < 4 * ref


@pytest.mark.parametrize("K", [2560, 6912])
def test_planar_tq2_0_on_card_equals_cpu(cuda, K):
    """Planar TQ2_0 (BitNet b1.58 2B-4T's K 2560 and 6912: no K-major tile)
    dequantizes on the card to the CPU's bits, and its product (dequantize,
    then an f32 matmul) agrees with the CPU's within 1e-6."""
    from tpullm_torch.ops.qmm import qmm
    from tpullm_torch.utils.synth import _mla_weight

    g = torch.Generator(device=cuda).manual_seed(K)
    qt = _mla_weight(640, K, (), g, cuda, GGMLType.TQ2_0)
    assert qt.layout == "planar"
    cpu = qt.to("cpu")
    assert torch.equal(qt.dequant(torch.float32).cpu(), cpu.dequant(torch.float32))
    x = torch.randn((4, K), generator=g, device=cuda)
    assert _nmse(qmm(x, qt, torch.float32).cpu(), qmm(x.cpu(), cpu, torch.float32)) < 1e-6
