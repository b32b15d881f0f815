"""The plain version of the port's flash attention (kernel C) held against
the JAX package's Pallas kernel in interpret mode and its einsum path, on
CPU: T = 128, head dim 128, a nonzero valid_from, softcap / sliding-window
cases, query-head groups of 1, 2 and 4 (MHA and GQA), and query slots at
0-127 over S = 256 or at 256-383 over S = 512 (a server chunk at depth)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.models.config import ModelConfig as JConfig
from tpullm.models.llama import attention as jattention
from tpullm.ops.flash_attention import flash_attention as jflash
from tpullm_torch.models.config import ModelConfig
from tpullm_torch.models.llama import attention
from tpullm_torch.ops.flash_attention import flash_attention, flash_supported

torch.set_num_threads(2)

B, T, S, H, HKV, D = 2, 128, 256, 4, 2, 128
VALID_FROM = (0, 37)


def _inputs(seed=0, H=H, HKV=HKV, S=S, n_past=0):
    r = np.random.default_rng(seed)
    q = (r.standard_normal((B, T, H, D)) * 0.5).astype(np.float32)
    k = (r.standard_normal((B, HKV, S, D)) * 0.5).astype(np.float32)
    v = (r.standard_normal((B, HKV, S, D)) * 0.5).astype(np.float32)
    vf = np.asarray(VALID_FROM, np.int32)
    qs = np.broadcast_to(n_past + np.arange(T, dtype=np.int32)[None], (B, T)).copy()
    pos = qs - vf[:, None]
    kvp = np.arange(S, dtype=np.int32)[None] - vf[:, None]
    return q, k, v, qs, kvp, pos, vf


def _nmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / max((b ** 2).mean(), 1e-30))


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 0), (0.0, 40)])
@pytest.mark.parametrize("heads", [(4, 2), (4, 4), (8, 2)], ids=["G2", "G1", "G4"])
@pytest.mark.parametrize("n_past,kv_len", [(0, 256), (256, 512)], ids=["slot0", "slot256"])
def test_flash_plain_vs_pallas(softcap, window, heads, n_past, kv_len):
    """Both sides take bf16 q/k/v. The Pallas kernel rounds unnormalized
    probabilities to bf16 and its output to bf16; the plain version rounds
    normalized probabilities: NMSE < 2e-4 (tests/test_flash_attention.py's
    bound for the kernel against the einsum path) on every row that has a
    visible key."""
    H, HKV = heads
    S = kv_len
    q, k, v, qs, kvp, pos, vf = _inputs(H=H, HKV=HKV, S=S, n_past=n_past)
    kw = dict(n_head=H, n_head_kv=HKV, head_dim=D, head_dim_v=D, n_embd=H * D,
              attn_logit_softcap=softcap, sliding_window=window)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    ji = lambda a: jnp.asarray(a, jnp.int32)
    want = np.asarray(jflash(jb(q), jb(k), jb(v), ji(qs), ji(kvp), ji(pos), ji(vf),
                             JConfig(**kw), bool(window), interpret=True), np.float32)
    tb = lambda a: torch.from_numpy(np.array(jb(a).astype(jnp.float32))).to(torch.bfloat16)
    tl = lambda a: torch.from_numpy(np.array(a, np.int64))
    assert flash_supported(T, S, D, D)
    got = flash_attention(tb(q), tb(k), tb(v), tl(qs), tl(kvp), tl(pos), tl(vf),
                          ModelConfig(**kw), bool(window)).float().numpy()
    assert got.shape == want.shape == (B, T, H, D)
    for b, f in enumerate(VALID_FROM):
        live = qs[b] >= f  # rows with a visible key
        assert live.any()
        assert _nmse(got[b, live], want[b, live]) < 2e-4


def test_padding_rows_zero_and_f32_einsum_match():
    """Left-padding rows (no visible key) give 0 in the port, as in the JAX
    einsum path (the Pallas kernel gives the mean of the V rows it visited
    there instead; those rows never reach a real token). In f32 the port's
    attention equals the JAX einsum path to summation order: NMSE < 1e-10."""
    q, k, v, qs, kvp, pos, vf = _inputs(1)
    kw = dict(n_head=H, n_head_kv=HKV, head_dim=D, head_dim_v=D, n_embd=H * D)
    want = np.asarray(jattention(*(jnp.asarray(a) for a in (q, k, v, qs, kvp, pos, vf)),
                                 JConfig(**kw), False))
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v)]
    ti = [torch.from_numpy(np.array(a, np.int64)) for a in (qs, kvp, pos, vf)]
    got = attention(*t, *ti, ModelConfig(**kw)).numpy()
    assert _nmse(got, want) < 1e-10
    assert not np.any(got[1, :VALID_FROM[1]])
