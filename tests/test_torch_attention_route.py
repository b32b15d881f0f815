"""The port's attention dispatch (tpullm_torch/models/llama.py:attention_route)
over a grid of shapes: a kernel is taken only on the card, and only where
the JAX package's gate (tpullm/ops/flash_attention.py:flash_supported,
tpullm/ops/flash_decode.py:flash_decode_supported, TPULLM_FLASH_DECODE
included) and the shapes its CUDA kernel builds both hold; every other
shape, and every call on the CPU, takes the einsum path. Head dim 64 on
kernel E is the port's own route: the JAX gate's conditions but Dk % 128.
What each kernel builds is written out here from its entry point's checks
(csrc/flash_attention.cu, csrc/flash_decode.cu), not read from the port."""
import pytest
import torch

from tpullm.ops.flash_attention import flash_supported as j_flash_supported
from tpullm.ops.flash_decode import flash_decode_supported as j_decode_supported
from tpullm_torch.models import llama
from tpullm_torch.models.llama import attention_route

HEAD_DIMS = [(128, 128), (256, 256), (384, 384), (512, 512), (128, 256), (256, 128), (80, 80),
             (64, 64)]
KV_DTYPES = [torch.bfloat16, torch.int8, torch.float32]


def _c_builds(T, S, Dk, Dv, H, Hkv):
    return Dk == Dv and Dk in (128, 256) and T % 64 == 0 and S % 64 == 0 and H % Hkv == 0


def _e_builds(T, Dk, Dv, H, Hkv, kv_dtype):
    return (Dk == Dv and Dk in (64, 128, 256) and 1 <= T <= 8 and H % Hkv == 0
            and (H // Hkv) * T <= 64 and kv_dtype in (torch.bfloat16, torch.int8))


def _e_own(flag, T, S, Dk, Dv):
    """The port's own route for E at head dim 64 (gpt-oss): the JAX gate's
    conditions (TPULLM_FLASH_DECODE, T <= 8, S a multiple of 256) with Dk =
    Dv = 64 in place of Dk % 128 == 0."""
    return bool(flag) and T <= 8 and Dk == Dv == 64 and S % 256 == 0 and S >= 256


@pytest.mark.parametrize("flag", [None, "1"])
@pytest.mark.parametrize("dk,dv", HEAD_DIMS)
def test_route_takes_a_kernel_only_where_gate_and_build_hold(monkeypatch, flag, dk, dv):
    if flag is None:
        monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
    else:
        monkeypatch.setenv("TPULLM_FLASH_DECODE", flag)
    seen = set()
    for T in (1, 2, 4, 8, 9, 64, 128, 256):
        for S in (128, 256, 1024, 1000):
            for H, Hkv in ((8, 8), (8, 2), (32, 8), (64, 8), (16, 1), (6, 4)):
                for dt in KV_DTYPES:
                    B = 2
                    assert attention_route(False, B, T, S, dk, dv, H, Hkv, dt) == "einsum"
                    got = attention_route(True, B, T, S, dk, dv, H, Hkv, dt)
                    e = ((j_decode_supported(B, T, S, dk, dv, Hkv) or _e_own(flag, T, S, dk, dv))
                         and _e_builds(T, dk, dv, H, Hkv, dt))
                    c = j_flash_supported(T, S, dk, dv) and _c_builds(T, S, dk, dv, H, Hkv)
                    want = "flash_decode" if e else "flash_attention" if c else "einsum"
                    assert got == want, (T, S, H, Hkv, dt, got, want)
                    seen.add(got)
    # the grid reaches each kernel where the head dims are built
    if (dk, dv) in ((128, 128), (256, 256)):
        assert seen == ({"flash_attention", "einsum"} | ({"flash_decode"} if flag else set()))
    if (dk, dv) == (64, 64):
        assert seen == {"einsum"} | ({"flash_decode"} if flag else set())
    elif dk not in (128, 256) or dk != dv:
        assert seen == {"einsum"}


def _attn_inputs(B, T, H, Hkv, S, D, q8):
    g = torch.Generator().manual_seed(5)
    q = torch.randn((B, T, H, D), generator=g).to(torch.bfloat16)
    k = torch.randn((B, Hkv, S, D), generator=g).to(torch.bfloat16)
    v = torch.randn((B, Hkv, S, D), generator=g).to(torch.bfloat16)
    qs = torch.full((B, T), S - T, dtype=torch.int64) + torch.arange(T)[None]
    vf = torch.zeros(B, dtype=torch.int64)
    kvp = torch.arange(S)[None] - vf[:, None]
    kv_q8 = None
    if q8:
        (kq, ksc), (vq, vsc) = llama._kv_quant(k), llama._kv_quant(v)
        kv_q8 = (kq, vq, ksc, vsc)
        k = v = None
    return q, k, v, qs, kvp, qs - vf[:, None], vf, kv_q8


@pytest.mark.parametrize("route", ["flash_decode", "flash_attention", "einsum"])
@pytest.mark.parametrize("q8", [False, True])
def test_attention_follows_the_route(monkeypatch, route, q8):
    """attention() calls the function the route names, with the raw int8
    views for kernel E and dequantized views for the others."""
    from tpullm_torch.models.config import ModelConfig

    calls = []

    def spy(name):
        def fn(q, k, v, *args, **kw):
            calls.append((name, k.dtype))
            return torch.zeros(q.shape[:3] + (v.shape[-1],), dtype=torch.bfloat16)
        return fn

    monkeypatch.setattr(llama, "attention_route", lambda *a: route)
    for name in ("flash_decode", "flash_attention", "masked_attention"):
        monkeypatch.setattr(llama, name, spy(name))
    cfg = ModelConfig(n_head=8, n_head_kv=2, head_dim=128, head_dim_v=128)
    q, k, v, qs, kvp, pos, vf, kv_q8 = _attn_inputs(2, 1, 8, 2, 256, 128, q8)
    llama.attention(q, k, v, qs, kvp, pos, vf, cfg, kv_q8=kv_q8)
    name = {"einsum": "masked_attention"}.get(route, route)
    want = torch.int8 if q8 and route == "flash_decode" else torch.bfloat16
    assert calls == [(name, want)]


@pytest.mark.parametrize("q8", [False, True])
def test_head_dim_256_on_cpu_takes_einsum_path(monkeypatch, q8):
    """With TPULLM_FLASH_DECODE set, a head-dim-256 decode and a prefill
    whose T is a multiple of 128 run on the CPU through the einsum path and
    give its values."""
    from tpullm_torch.models.config import ModelConfig
    from tpullm_torch.models.llama import attention, dequant_view
    from tpullm_torch.ops.flash_attention import attention_params, masked_attention

    monkeypatch.setenv("TPULLM_FLASH_DECODE", "1")
    cfg = ModelConfig(n_head=4, n_head_kv=2, head_dim=256, head_dim_v=256)
    for T in (1, 128):
        q, k, v, qs, kvp, pos, vf, kv_q8 = _attn_inputs(1, T, 4, 2, 256, 256, q8)
        got = attention(q, k, v, qs, kvp, pos, vf, cfg, kv_q8=kv_q8)
        if q8:
            k = dequant_view(kv_q8[0], kv_q8[2], q.dtype)
            v = dequant_view(kv_q8[1], kv_q8[3], q.dtype)
        want = masked_attention(q, k, v, qs, kvp, pos, vf, *attention_params(cfg, False))
        assert torch.equal(got, want)


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("S", [1, 127, 128, 129, 1000, 1024, 1025, 2048, 8192, 8193])
def test_counters_per_row_covers_every_live_range(S, q8):
    """Kernel E's arrival counters for one (batch row, kv head): for every
    range of live splits [sp0, sp1] the kernel can see over an S-slot view,
    the counter indices it touches (group (sp - sp0) // E_GRP of each live
    split, and the last one for the groups) are distinct and below
    counters_per_row(S), counted by brute force."""
    from tpullm_torch.ops.flash_decode import E_CH, E_GRP, counters_per_row

    NS = -(-S // E_CH[q8])
    n = counters_per_row(S, q8)
    need = 0
    for sp0 in range(NS):
        for sp1 in range(sp0, NS):
            groups = {(sp - sp0) // E_GRP for sp in range(sp0, sp1 + 1)}
            total = NS // E_GRP + 1  # the kernel's index of the groups' counter
            assert total not in groups
            need = max(need, max(groups) + 1, total + 1)
    assert need <= n
    assert n <= need + 1


@pytest.mark.parametrize("flag", [None, "1"])
@pytest.mark.parametrize("dk,dv", HEAD_DIMS)
def test_ring_route_is_a_kernel_wherever_one_builds(monkeypatch, flag, dk, dv):
    """A call on an iSWA ring bank (``ring`` = S) is the port's own route,
    since the JAX package sends every ring call to its einsum path
    (tpullm/models/llama.py:268, 277): kernel E where TPULLM_FLASH_DECODE
    is set and E builds its ring (bf16 K/V), whatever the ring's slot
    count (T <= 8, head dims multiples of 128 up to 512, or 64); else kernel C
    wherever it builds over the ring (any T, the ring a multiple of 64);
    the einsum path only where neither builds, and on the CPU. decode_route
    gives the pair (full banks, ring) on a dual cache."""
    from tpullm_torch.models.config import ModelConfig
    from tpullm_torch.models.llama import decode_route

    if flag is None:
        monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
    else:
        monkeypatch.setenv("TPULLM_FLASH_DECODE", flag)
    for T in (1, 4, 8, 9, 32, 40, 64, 512):
        for ring in (4608, 4160, 384, 200):
            for H, Hkv in ((16, 8), (8, 2), (64, 8), (6, 4)):
                for dt in KV_DTYPES:
                    assert attention_route(False, 2, T, ring, dk, dv, H, Hkv, dt,
                                           ring) == "einsum"
                    got = attention_route(True, 2, T, ring, dk, dv, H, Hkv, dt, ring)
                    e = (bool(flag) and T <= 8 and ((dk % 128 == 0 and dv % 128 == 0
                                                     and max(dk, dv) <= 512) or dk == dv == 64)
                         and dt == torch.bfloat16 and _e_builds(T, dk, dv, H, Hkv, dt))
                    c = dk == dv and dk in (128, 256) and ring % 64 == 0 and H % Hkv == 0
                    want = "flash_decode" if e else "flash_attention" if c else "einsum"
                    assert got == want, (T, ring, H, Hkv, dt, got, want)
    cfg = ModelConfig(n_head=16, n_head_kv=8, head_dim=256, head_dim_v=256)
    full = decode_route(cfg, 4, 8192, torch.bfloat16, True)
    assert decode_route(cfg, 4, 8192, torch.bfloat16, True, 4608) == (
        full, "flash_decode" if flag else "flash_attention")
