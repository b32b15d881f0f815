"""The port's int8 KV cache against the JAX package's: the row quantizer
bit for bit, and forward() with a q8 cache in the batch engine's layout and
in the server's (per-slot prefills through ``slot0`` with ``logits_idx``,
then decode steps with a per-row ``cache_pos``), on the same Q4_K GGUF in
f32. Logits agree at NMSE < 1e-6 (the arch-snapshot bar: only float
summation order differs); the int8 rows written are identical, and their
scales agree to rtol 2e-6 (a few last bits: both sides' K and V differ by
f32 summation order before they are quantized)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGMLType
from tpullm.models.llama import KVCache as JKVCache
from tpullm.models.llama import _kv_quant as j_kv_quant
from tpullm.models.llama import forward as j_forward
from tpullm.runtime.loader import load_model as jload
from tpullm.utils.synth import build_llama_gguf
from tpullm_torch.models.llama import KVCache, _kv_quant, forward
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.utils.from_jax import kv_cache_from_numpy

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_kvq") / "llama_q4k.gguf")
    build_llama_gguf(path, vocab_size=512, n_embd=512, n_layer=2, n_head=4, n_head_kv=2,
                     n_ff=512, qtype=GGMLType.Q4_K, seed=11)
    jcfg, jparams, _ = jload(path)
    cfg, params, _ = load_model(path, device="cpu")
    return jcfg, jparams, cfg, params


def _nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / max((b ** 2).mean(), 1e-30))


@pytest.mark.parametrize("shape,scale", [((2, 5, 3, 128), 1.0), ((1, 64, 2, 256), 1e-3),
                                         ((3, 7, 1, 64), 50.0)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kv_quant_bit_exact(shape, scale, dtype):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: scale 0, values 0
    x[-1, -1, -1, :4] = [127.5, -127.5, 0.5, 1.5]  # ties round to even
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    jq, js = j_kv_quant(jx)
    tq, ts = _kv_quant(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _jfwd(jcfg, **static):
    return jax.jit(lambda p, tok, pos, c, cp, vf, s0, li: j_forward(
        p, jcfg, tok, pos, c, cp, vf, jnp.float32, slot0=s0, logits_idx=li, **static))


def _check_cache(cache: KVCache, jc, rows, slots):
    """Written rows [rows] x slots [:slots[b]]: int8 values identical,
    scales to the last bits (see the module note)."""
    for b, n in zip(rows, slots):
        for port, ref in ((cache.ks, jc.ks), (cache.vs, jc.vs)):
            np.testing.assert_allclose(port[:, b, :, :n].numpy(), np.asarray(ref)[:, b, :, :n],
                                       rtol=2e-6, atol=0)
        for port, ref in ((cache.k, jc.k), (cache.v, jc.v)):
            np.testing.assert_array_equal(port[:, b, :, :n].numpy(), np.asarray(ref)[:, b, :, :n])
    assert cache.k.dtype == torch.int8 and cache.ks.dtype == torch.float32


def test_forward_q8_engine_layout(models):
    """Left-padded batch prefill at a scalar cache_pos, then two decode
    steps, into a q8 cache shared by both rows."""
    jcfg, jparams, cfg, params = models
    B, T, S = 2, 8, 64
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 512, (B, T)).astype(np.int32)
    vf = np.asarray([0, 3], np.int32)
    pos = np.maximum(np.arange(T)[None] - vf[:, None], 0).astype(np.int32)
    jc = JKVCache.create(jcfg, B, S, "q8")
    cache = KVCache.create(cfg, B, S, "q8", "cpu")
    fj = jax.jit(lambda p, t, ps, c, cp, v: j_forward(p, jcfg, t, ps, c, cp, v, jnp.float32))
    slot = 0
    for step in range(3):
        jl, jc = fj(jparams, jnp.asarray(tok), jnp.asarray(pos), jc, jnp.int32(slot),
                    jnp.asarray(vf))
        tl, cache = forward(params, cfg, torch.from_numpy(tok).long(),
                            torch.from_numpy(pos).long(), cache, slot,
                            torch.from_numpy(vf).long(), torch.float32)
        assert _nmse(tl.numpy(), np.asarray(jl)) < 1e-6, step
        slot += tok.shape[1]
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        pos = pos[:, -1:] + 1
    _check_cache(cache, jc, [0, 1], [slot, slot])


def test_forward_q8_server_layout(models):
    """Three slots: per-slot bucketed prefills through slot0 (slot 2 in two
    chunks, the second at cache_pos 4) with logits for the last real token
    only, then decode steps over all slots at their own depths with a
    per-row cache_pos and a bounded view."""
    jcfg, jparams, cfg, params = models
    n_slots, S = 3, 64
    rng = np.random.default_rng(1)
    prompts = {1: rng.integers(0, 512, 7), 0: rng.integers(0, 512, 5),
               2: rng.integers(0, 512, 8)}
    jc = JKVCache.create(jcfg, n_slots, S, "q8")
    cache = KVCache.create(cfg, n_slots, S, "q8", "cpu")
    fj = _jfwd(jcfg)
    zero = np.zeros((1,), np.int32)
    n_past = {}
    last = {}
    for slot, chunks in ((1, [prompts[1]]), (0, [prompts[0]]),
                         (2, [prompts[2][:4], prompts[2][4:]])):
        p0 = 0
        for chunk in chunks:
            Tc, Tb = len(chunk), 8
            tok = np.zeros((1, Tb), np.int32)
            tok[0, :Tc] = chunk
            pos = (p0 + np.arange(Tb, dtype=np.int32))[None]
            jl, jc = fj(jparams, jnp.asarray(tok), jnp.asarray(pos), jc, jnp.int32(p0),
                        jnp.asarray(zero), jnp.int32(slot), jnp.int32(Tc - 1))
            tl, cache = forward(params, cfg, torch.from_numpy(tok).long(),
                                torch.from_numpy(pos).long(), cache, p0,
                                torch.zeros(1, dtype=torch.int64), torch.float32, slot0=slot,
                                logits_idx=Tc - 1)
            assert tl.shape == (1, 1, cfg.vocab_size)
            assert _nmse(tl.numpy(), np.asarray(jl)) < 1e-6, (slot, p0)
            p0 += Tc
        n_past[slot] = p0
        last[slot] = int(np.asarray(jl)[0, 0].argmax())
    cp = np.asarray([n_past[i] for i in range(n_slots)], np.int32)  # 5, 7, 8
    tok = np.asarray([[last[i]] for i in range(n_slots)], np.int32)
    fjd = jax.jit(lambda p, t, ps, c, cp, v: j_forward(p, jcfg, t, ps, c, cp, v, jnp.float32,
                                                       kv_view_len=32))
    vf = np.zeros((n_slots,), np.int32)
    for step in range(3):
        jl, jc = fjd(jparams, jnp.asarray(tok), jnp.asarray(cp[:, None]), jc, jnp.asarray(cp),
                     jnp.asarray(vf))
        tl, cache = forward(params, cfg, torch.from_numpy(tok).long(),
                            torch.from_numpy(cp[:, None]).long(), cache,
                            torch.from_numpy(cp).long(), torch.from_numpy(vf).long(),
                            torch.float32, kv_view_len=32)
        assert _nmse(tl.numpy(), np.asarray(jl)) < 1e-6, step
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        cp = cp + 1
    _check_cache(cache, jc, range(n_slots), cp.tolist())


def test_kv_cache_from_numpy_carries_jax_cache(models):
    jcfg, _, cfg, _ = models
    for dt in ("q8", jnp.bfloat16):
        jc = JKVCache.create(jcfg, 2, 16, dt)
        jc = dataclasses.replace(jc, k=jc.k + 1)
        c = kv_cache_from_numpy(*(None if a is None else np.asarray(a)
                                  for a in (jc.k, jc.v, jc.ks, jc.vs)), device="cpu")
        assert c.quantized == (dt == "q8")
        assert c.k.shape == tuple(jc.k.shape) and int(c.k.float().sum()) == int(
            np.asarray(jc.k, np.float32).sum())
