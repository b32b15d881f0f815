"""The port's planar layout held against the JAX package: ops/dequant.py
bit-exact with tpullm/ops/dequant.py for Q8_0, and Q8_0 weights too short
for a K tile loading, dequantizing, gathering rows and multiplying as the
JAX package's do (Q4_K, the other planar type the port covers, is held in
tests/test_torch_qwen_moe.py). Every other weight that would be planar
raises at load."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGML_QUANT_SIZES, GGMLType
from tpullm.ops.dequant import dequant_jax
from tpullm.ops.qmm import qmm as jqmm
from tpullm.ops.qtensor import qtensor_from_bytes as jfrom_bytes
from tpullm.quant import quantize
from tpullm_torch.ops.dequant import dequant_torch
from tpullm_torch.ops.qmm import qmm
from tpullm_torch.ops.qtensor import qtensor_from_bytes

torch.set_num_threads(2)


def _raw(shape, seed=0):
    rng = np.random.default_rng(seed)
    rows = int(np.prod(shape[:-1]))
    w = (rng.standard_normal((rows, shape[-1])) * 0.02).astype(np.float32)
    return quantize(w, GGMLType.Q8_0).reshape(-1)


@pytest.mark.parametrize("shape", [(3, 5, 256), (40, 64), (4, 96, 64), (7, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dequant_planar_bit_exact(shape):
    """Q8_0 weights from the JAX package's planar arrays: f32 dequant equal
    bit for bit, leading dims kept."""
    jq = jfrom_bytes(_raw(shape), GGMLType.Q8_0, shape, device_put=False, layout="planar")
    planar = {k: torch.from_numpy(np.array(v)) for k, v in jq.data.items()}
    want = np.asarray(dequant_jax(jq.data, GGMLType.Q8_0, jnp.float32))
    got = dequant_torch(planar, GGMLType.Q8_0, torch.float32)
    assert got.shape == want.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("K", [32, 64, 96])
def test_planar_qtensor_matches_jax(K):
    """A Q8_0 weight with rows shorter than the type's K tile loads planar
    in both packages; the port's qmm (dequant, then the f32-accumulated
    product) and row gather give the JAX package's values."""
    shape = (40, K)
    raw = _raw(shape, seed=2)
    jq = jfrom_bytes(raw, GGMLType.Q8_0, shape, device_put=False)
    q = qtensor_from_bytes(raw, GGMLType.Q8_0, shape)
    assert jq.layout == q.layout == "planar"
    for k, v in jq.data.items():
        np.testing.assert_array_equal(q.data[k].numpy(), np.asarray(v))
    x = (np.random.default_rng(3).standard_normal((3, 7, K))).astype(np.float32)
    want = np.asarray(jqmm(jnp.asarray(x), jq, jnp.float32))
    got = qmm(torch.from_numpy(x), q, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    idx = np.array([[3, 0, 39], [7, 7, 1]])
    np.testing.assert_array_equal(
        q.take_rows(torch.from_numpy(idx), torch.float32).numpy(),
        np.asarray(jq.take_rows(jnp.asarray(idx), jnp.float32)))


def test_planar_experts_stacked():
    """(E, n, k) experts too short for a K tile stay planar, per expert, as
    in the JAX package (the Mixtral snapshot's Q8_0 experts at n_embd 64)."""
    shape = (4, 96, 64)
    raw = _raw(shape, seed=4)
    jq = jfrom_bytes(raw, GGMLType.Q8_0, shape, device_put=False)
    q = qtensor_from_bytes(raw, GGMLType.Q8_0, shape)
    assert q.layout == jq.layout == "planar" and q.shape == shape
    np.testing.assert_array_equal(q.dequant(torch.float32).numpy(),
                                  np.asarray(jq.dequant(jnp.float32)))


# block types that the JAX package would hold planar at these rows: no
# K-major layout (Q8_K, IQ4_XS) or rows too short for a K tile (Q5_0
# loads planar since it is ported: tests/test_torch_moe_families.py; TQ2_0
# too: tests/test_torch_dense_singles.py; IQ4_XS at K 6912 takes its case)
PLANAR_ELSEWHERE = [(GGMLType.Q4_0, 64), (GGMLType.Q4_1, 64), (GGMLType.Q5_1, 128),
                    (GGMLType.Q5_1, 64), (GGMLType.IQ4_NL, 64), (GGMLType.IQ4_NL, 128),
                    (GGMLType.Q4_1, 128), (GGMLType.Q8_K, 256), (GGMLType.IQ4_XS, 256),
                    (GGMLType.IQ4_XS, 6912)]


@pytest.mark.parametrize("qtype,K", PLANAR_ELSEWHERE, ids=lambda v: getattr(v, "name", v))
def test_other_planar_types_raise(qtype, K):
    """The planar layout is ported for Q8_0, Q4_K, MXFP4, Q5_0 and TQ2_0 only: a weight
    of another type that the JAX package would hold planar raises at load,
    naming its type (planar MXFP4: tests/test_torch_sinks.py)."""
    shape = (4, K)
    blk, bs = GGML_QUANT_SIZES[qtype]
    raw = np.zeros(4 * K // blk * bs, np.uint8)
    assert jfrom_bytes(raw, qtype, shape, device_put=False).layout == "planar"
    with pytest.raises(NotImplementedError, match=qtype.name):
        qtensor_from_bytes(raw, qtype, shape)
