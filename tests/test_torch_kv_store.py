"""The KV store (ops/kv_store.py) on the CPU: its plain version against the
cache banks the JAX package's forward writes, bit for bit, on bf16 and int8
caches in every layout the port writes (the batch engine's int start, the
server's per-row depths with a parked row at the last slot, a prefill chunk
into one slot through ``slot0``, and one whose bucket runs past the cache's
end, where the writes are dropped); the wrapper on CPU tensors; and the
operands the CUDA kernel takes. The kernel itself is held against the plain
version on the card (tests/test_torch_gpu.py).

The K/V rows the JAX forward stores are internal to it (``_store``), so they
are read as it computes them: on the int8 cache from the calls of its
``_kv_quant`` (wrapped, with JIT off so the layer scan runs in Python), on
the bf16 cache from a twin f32 cache with the same content (in bf16 compute
both caches hold and read back the same values, and the f32 one keeps the
rows exactly)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpullm.models.llama as jllama
from tpullm.gguf.constants import GGMLType
from tpullm.models.llama import KVCache as JKVCache
from tpullm.runtime.loader import load_model as jload
from tpullm.utils.synth import build_llama_gguf
from tpullm_torch.ops import _cuda
from tpullm_torch.ops.kv_store import kv_store, kv_store_builds, kv_store_plain
from tpullm_torch.utils.from_jax import kv_cache_from_numpy

torch.set_num_threads(2)

S = 64
N_ROWS = 3  # cache batch rows (slots)
# layout: (B, T, first slot of each row (int: every row), slot0)
LAYOUTS = {
    "engine": (3, 4, 10, None),
    "rows": (3, 1, [5, 17, S - 1], None),  # per-row depths; row 2 parked at the last slot
    "slot0": (1, 8, 8, 2),  # a prefill chunk into slot 2
    "slot0_end": (1, 8, S - 4, 1),  # its bucket's last 4 slots are past the end: dropped
}


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_kv_store") / "llama_q4k.gguf")
    build_llama_gguf(path, vocab_size=512, n_embd=512, n_layer=2, n_head=4, n_head_kv=2,
                     n_ff=512, qtype=GGMLType.Q4_K, seed=11)
    jcfg, jparams, _ = jload(path)
    return jcfg, jparams


def _pre_cache(jcfg, kind, seed):
    """(JAX cache, numpy parts) with random content in every slot, so the
    slots a store leaves alone show it."""
    rng = np.random.default_rng(seed)
    shape = (jcfg.n_layer, N_ROWS, jcfg.n_head_kv, S, jcfg.head_dim)
    if kind == "q8":
        parts = (rng.integers(-127, 128, shape).astype(np.int8),
                 rng.integers(-127, 128, shape).astype(np.int8),
                 (rng.random(shape[:-1]) * 0.02).astype(np.float32),
                 (rng.random(shape[:-1]) * 0.02).astype(np.float32))
        return JKVCache(*(jnp.asarray(p) for p in parts)), parts
    parts = tuple(np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
                  for _ in range(2))
    return JKVCache(*(jnp.asarray(p) for p in parts)), parts


def _inputs(jcfg, layout, seed):
    B, T, first, slot0 = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    starts = np.broadcast_to(np.asarray(first, np.int64), (B,)).copy()
    pos = (starts[:, None] + np.arange(T)[None]).astype(np.int32)
    cache_pos = jnp.asarray(starts, jnp.int32) if isinstance(first, list) else jnp.int32(first)
    return tok, pos, cache_pos, starts, slot0


def _jax_store(jcfg, jparams, kind, layout, seed):
    """The JAX forward's store on one layout -> (cache parts before, parts
    after, [(k, v)] of each layer as the forward stored them, f32 numpy)."""
    jc, pre = _pre_cache(jcfg, kind, seed)
    tok, pos, cache_pos, starts, slot0 = _inputs(jcfg, layout, seed + 1)
    B, T = tok.shape
    vf = jnp.zeros((B,), jnp.int32)
    s0 = None if slot0 is None else jnp.int32(slot0)
    if kind == "q8":
        seen = []
        real = jllama._kv_quant

        def spy(x):
            seen.append(np.array(x, np.float32))
            return real(x)

        jllama._kv_quant = spy
        try:
            with jax.disable_jit():
                _, out = jllama.forward(jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), jc,
                                        cache_pos, vf, jnp.float32, slot0=s0)
        finally:
            jllama._kv_quant = real
        assert len(seen) == 2 * jcfg.n_layer
        return pre, tuple(np.asarray(a) for a in (out.k, out.v, out.ks, out.vs)), \
            list(zip(seen[0::2], seen[1::2]))
    fwd = jax.jit(lambda c: jllama.forward(jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos),
                                           c, cache_pos, vf, jnp.bfloat16, slot0=s0)[1])
    out = fwd(jc)
    twin = fwd(JKVCache(*(jnp.asarray(p, jnp.float32) for p in pre)))
    tk, tv = np.asarray(twin.k), np.asarray(twin.v)
    rows = np.arange(B) + (slot0 or 0)
    kv = []
    for li in range(jcfg.n_layer):
        k = np.zeros((B, T, jcfg.n_head_kv, jcfg.head_dim), np.float32)
        v = np.zeros_like(k)
        for b in range(B):
            for t in range(T):
                s = starts[b] + t
                if s < S:
                    k[b, t], v[b, t] = tk[li, rows[b], :, s], tv[li, rows[b], :, s]
                else:  # dropped: any value; the store must leave the cache alone
                    k[b, t] = v[b, t] = 1e4
        kv.append((k, v))
    return pre, (np.asarray(out.k), np.asarray(out.v)), kv


def _bits(a):
    """An array as numpy, bf16 as its bit pattern."""
    if torch.is_tensor(a):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", ["bf16", "q8"])
def test_kv_store_plain_matches_jax_forward(model, kind, layout):
    """kv_store_plain, fed the rows the JAX forward stored, leaves every bank
    (values and, on the int8 cache, row scales) equal bit for bit to the
    JAX forward's, from the same content before."""
    jcfg, jparams = model
    seed = 7 + list(LAYOUTS).index(layout)
    pre, post, kv = _jax_store(jcfg, jparams, kind, layout, seed)
    _, _, _, starts, slot0 = _inputs(jcfg, layout, seed + 1)
    cache = kv_cache_from_numpy(*pre, *((None, None) if kind == "bf16" else ()),
                                device="cpu")
    dtype = torch.float32 if kind == "q8" else torch.bfloat16
    slot = torch.from_numpy(starts)
    for li, (k, v) in enumerate(kv):
        scales = (cache.ks[li], cache.vs[li]) if kind == "q8" else (None, None)
        kv_store_plain(cache.k[li], cache.v[li], torch.from_numpy(k).to(dtype),
                       torch.from_numpy(v).to(dtype), slot, slot0 or 0, *scales)
    got = [cache.k, cache.v] + ([cache.ks, cache.vs] if kind == "q8" else [])
    for g, want in zip(got, post):
        np.testing.assert_array_equal(_bits(g), _bits(want))
    T = LAYOUTS[layout][1]
    written = sum(min(T, S - s) for s in starts) * jcfg.n_head_kv * jcfg.n_layer
    assert 0 < (_bits(got[0]) != _bits(pre[0])).any(axis=-1).sum() <= written


def test_kv_store_on_the_cpu_is_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches (and
    counts) nothing; rows at and past the end are dropped, from any start."""
    g = torch.Generator().manual_seed(0)
    k = torch.randn((2, 5, 2, 64), generator=g).to(torch.bfloat16)
    v = torch.randn((2, 5, 2, 32), generator=g).to(torch.bfloat16)
    slot = torch.tensor([3, 14])
    banks = [torch.zeros((3, 2, 16, 64), dtype=torch.int8),
             torch.zeros((3, 2, 16, 32), dtype=torch.int8),
             torch.zeros((3, 2, 16)), torch.zeros((3, 2, 16))]
    twin = [b.clone() for b in banks]
    _cuda.reset_counts()
    kv_store(banks[0], banks[1], k, v, slot, 1, banks[2], banks[3])
    kv_store_plain(twin[0], twin[1], k, v, slot, 1, twin[2], twin[3])
    assert _cuda.COUNTS["kv_store"] == 0
    for a, b in zip(banks, twin):
        assert torch.equal(a, b)
    assert (banks[2][1, :, 3:8] > 0).all() and (banks[2][2, :, 14:16] > 0).all()
    assert banks[2][2, :, :14].eq(0).all() and banks[2][0].eq(0).all()
    assert banks[2][1, :, 8:].eq(0).all() and banks[2][1, :, :3].eq(0).all()


@pytest.mark.parametrize("rows", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("bank", [torch.bfloat16, torch.float32, torch.int8, torch.float16])
@pytest.mark.parametrize("quantized", [False, True])
def test_kv_store_builds(rows, bank, quantized):
    """The kernel takes bf16 or f32 rows into bf16 or f32 banks, or into
    int8 banks with scales; the same heads and head dims on both sides and
    rows whose last dim is contiguous."""
    k = torch.zeros((2, 3, 2, 128), dtype=rows)
    v = torch.zeros((2, 3, 2, 64), dtype=rows)
    kb = torch.zeros((4, 2, 32, 128), dtype=bank)
    vb = torch.zeros((4, 2, 32, 64), dtype=bank)
    want = (rows in (torch.bfloat16, torch.float32)
            and bank in (torch.bfloat16, torch.float32, torch.int8)
            and (bank == torch.int8) == quantized)
    assert kv_store_builds(k, v, kb, vb, quantized) == want
    if want:
        y = torch.zeros((2, 3, 2 * 128 + 2 * 64 + 64), dtype=rows)
        v_view = y[..., 256: 384].reshape(2, 3, 2, 64)  # a slice of a fused QKV output
        assert kv_store_builds(k, v_view, kb, vb, quantized)
        assert not kv_store_builds(k, v.transpose(-1, -2).contiguous().transpose(-1, -2),
                                   kb, vb, quantized)
        assert not kv_store_builds(k, v, kb, vb[:, :1].contiguous(), quantized)
        assert not kv_store_builds(k, v, kb, kb, quantized)
