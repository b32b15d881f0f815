"""Kernel E's plain version (tpullm_torch/ops/flash_decode.py, the function
the wrapper runs for tensors on the CPU) against the JAX package's
flash_decode in interpret mode and its einsum attention, on the five cases
of tests/test_flash_decode.py, with that suite's bounds: NMSE < 1e-4, and
< 1e-3 for multi-token int8 against the einsum path over the dequantized
rows (the kernel folds the scales into scores and probabilities instead).
Inputs are drawn with numpy from fixed seeds and handed to both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.models.config import ModelConfig as JConfig
from tpullm.models.llama import _kv_quant as j_kv_quant
from tpullm.models.llama import attention as j_attention
from tpullm.ops.flash_decode import flash_decode as j_flash_decode
from tpullm_torch.models.config import ModelConfig
from tpullm_torch.models.llama import _kv_quant
from tpullm_torch.ops.flash_decode import flash_decode, flash_decode_supported

torch.set_num_threads(2)


def _mk(B=2, T=1, H=8, Hkv=2, Dk=128, Dv=128, S=1024, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, T, H, Dk)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((B, S, Hkv, Dk)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((B, S, Hkv, Dv)) * 0.3).astype(np.float32)
    q_slots = (rng.integers(T, S - T, (B, 1)) + np.arange(T)[None, :]).astype(np.int32)
    valid_from = rng.integers(0, 4, (B,)).astype(np.int32)
    positions = q_slots - valid_from[:, None]
    return q, k, v, q_slots, valid_from, positions


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16) of the same values."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / max((b ** 2).mean(), 1e-12))


def _np(t):
    return t.float().numpy()


def _cfgs(**kw):
    d = dict(arch="llama", vocab_size=64, n_embd=1024, n_layer=1, n_head=8, n_head_kv=2,
             n_ff=64, head_dim=128, head_dim_v=128)
    d.update(kw)
    return JConfig(**d), ModelConfig(**d)


def _run(mk, cfg_kw, window=0, sinks=None, int8=False):
    """-> (port out, JAX interpret-mode kernel out, JAX einsum out)."""
    q, k, v, qs, vf, pos = mk
    jcfg, cfg = _cfgs(**cfg_kw)
    jq, tq = _bf16(q)
    T = q.shape[1]
    S = k.shape[1]
    tqs, tvf, tpos = (torch.from_numpy(a.astype(np.int64)) for a in (qs, vf, pos))
    kvp = jnp.arange(S)[None, :] - jnp.asarray(vf)[:, None]
    jsinks = None if sinks is None else jnp.asarray(sinks)
    tsinks = None if sinks is None else torch.from_numpy(sinks)
    swa = bool(window)
    if int8:
        jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        kq, ks = j_kv_quant(jk)
        vq, vs = j_kv_quant(jv)
        kd = (kq.astype(jnp.float32) * ks[..., None]).astype(jnp.bfloat16)
        vd = (vq.astype(jnp.float32) * vs[..., None]).astype(jnp.bfloat16)
        ref = jax.jit(lambda *a: j_attention(*a, jcfg, layer_is_swa=swa, sinks=jsinks))(
            jq, kd.transpose(0, 2, 1, 3), vd.transpose(0, 2, 1, 3), qs, kvp, pos, vf)
        kern = jax.jit(lambda *a: j_flash_decode(
            *a, jcfg, window=window, sinks=jsinks, k_scales=ks.transpose(0, 2, 1),
            v_scales=vs.transpose(0, 2, 1), interpret=True))(
            jq, kq.transpose(0, 2, 1, 3), vq.transpose(0, 2, 1, 3), qs, pos, vf)
        tkq, tks = _kv_quant(_bf16(k)[1])
        tvq, tvs = _kv_quant(_bf16(v)[1])
        assert np.array_equal(tkq.numpy(), np.asarray(kq))
        assert np.array_equal(tks.numpy(), np.asarray(ks))
        out = flash_decode(tq, tkq.transpose(1, 2), tvq.transpose(1, 2), tqs, tpos, tvf, cfg,
                           window=window, sinks=tsinks, k_scales=tks.transpose(1, 2),
                           v_scales=tvs.transpose(1, 2))
    else:
        jk = jnp.asarray(k, jnp.bfloat16).transpose(0, 2, 1, 3)
        jv = jnp.asarray(v, jnp.bfloat16).transpose(0, 2, 1, 3)
        ref = jax.jit(lambda *a: j_attention(*a, jcfg, layer_is_swa=swa, sinks=jsinks))(
            jq, jk, jv, qs, kvp, pos, vf)
        kern = jax.jit(lambda *a: j_flash_decode(*a, jcfg, window=window, sinks=jsinks,
                                                 interpret=True))(jq, jk, jv, qs, pos, vf)
        out = flash_decode(tq, _bf16(k)[1].transpose(1, 2), _bf16(v)[1].transpose(1, 2),
                           tqs, tpos, tvf, cfg, window=window, sinks=tsinks)
    assert out.shape == (q.shape[0], T, q.shape[2], v.shape[-1]) and out.dtype == torch.bfloat16
    return _np(out), np.asarray(kern, np.float32), np.asarray(ref, np.float32)


CASES = {
    "plain": (dict(), dict(), {}),
    "swa_softcap_sinks": (dict(seed=1), dict(sliding_window=256, attn_logit_softcap=30.0),
                          dict(window=256, sinks=2)),
    "chunked_window": (dict(seed=3), dict(sliding_window=128, swa_chunked=True),
                       dict(window=128)),
    "multitoken_int8": (dict(T=4, seed=4), dict(), dict(int8=True)),
    "mqa_big_head": (dict(H=4, Hkv=1, Dk=256, Dv=256, S=512, seed=5),
                     dict(n_head=4, n_head_kv=1, head_dim=256, head_dim_v=256), {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_flash_decode_matches_jax(case):
    mk_kw, cfg_kw, run_kw = CASES[case]
    mk = _mk(**mk_kw)
    if "sinks" in run_kw:
        run_kw = dict(run_kw, sinks=np.random.default_rng(run_kw["sinks"]).standard_normal(
            mk[0].shape[2]).astype(np.float32))
    out, kern, ref = _run(mk, cfg_kw, **run_kw)
    tol = 1e-3 if run_kw.get("int8") else 1e-4
    assert _nmse(out, kern) < 1e-4, _nmse(out, kern)
    assert _nmse(out, ref) < tol, _nmse(out, ref)


@pytest.mark.parametrize("int8", [False, True])
def test_row_with_no_visible_key_is_zero(int8):
    """valid_from past the row's query slot: nothing to attend, output 0
    (with a sink too, which has no value row)."""
    q, k, v, qs, vf, pos = _mk(B=2, seed=7)
    vf = np.asarray([qs[0, 0] + 1, 0], np.int32)
    pos = qs - vf[:, None]
    sinks = np.random.default_rng(8).standard_normal(8).astype(np.float32)
    out, _, ref = _run((q, k, v, qs, vf, pos), {}, sinks=sinks, int8=int8)
    assert not out[0].any()
    assert not ref[0].any()
    assert _nmse(out[1], ref[1]) < (1e-3 if int8 else 1e-4)


def test_supported_gate_matches_jax(monkeypatch):
    """The JAX package's gate, environment variable included."""
    from tpullm.ops.flash_decode import flash_decode_supported as j_supported

    shapes = [(1, 1, 1024, 128, 128, 8), (1, 16, 1024, 128, 128, 8),
              (1, 1, 1000, 128, 128, 8), (1, 1, 1024, 80, 80, 8),
              (1, 1, 1024, 576, 512, 1), (4, 8, 8192, 256, 256, 1), (1, 1, 128, 128, 128, 8)]
    for env in (None, "1"):
        if env is None:
            monkeypatch.delenv("TPULLM_FLASH_DECODE", raising=False)
        else:
            monkeypatch.setenv("TPULLM_FLASH_DECODE", env)
        for s in shapes:
            assert flash_decode_supported(*s) == j_supported(*s), (env, s)


def test_attention_flag_on_cpu_takes_einsum_path(monkeypatch):
    """With TPULLM_FLASH_DECODE set and the tensors on the CPU, the port's
    attention() takes the einsum path, as the JAX package does off the TPU."""
    from tpullm_torch.models.llama import attention
    from tpullm_torch.ops.flash_attention import attention_params, masked_attention

    monkeypatch.setenv("TPULLM_FLASH_DECODE", "1")
    q, k, v, qs, vf, pos = _mk(seed=9)
    _, cfg = _cfgs()
    tq = _bf16(q)[1]
    tk, tv = _bf16(k)[1].transpose(1, 2), _bf16(v)[1].transpose(1, 2)
    tqs, tvf, tpos = (torch.from_numpy(a.astype(np.int64)) for a in (qs, vf, pos))
    kvp = torch.arange(k.shape[1])[None] - tvf[:, None]
    got = attention(tq, tk, tv, tqs, kvp, tpos, tvf, cfg)
    want = masked_attention(tq, tk, tv, tqs, kvp, tpos, tvf, *attention_params(cfg, False))
    assert torch.equal(got, want)
