"""The port's K-major weights and plain qmm held against the JAX package:
dequant_kmajor_torch bit-exact with dequant_kmajor_jnp for all 14 K-major
types, the copied repack equal to the JAX one, and the plain version of
kernels A/B against qmm_kmajor's Pallas kernels in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGMLType
from tpullm.ops.qmm import qmm as jqmm
from tpullm.ops.qmm import qmm_kmajor as jqmm_kmajor
from tpullm.ops.qtensor import QTensor as JQTensor
from tpullm.ops.qtensor import qtensor_from_bytes as jfrom_bytes
from tpullm.quant.kmajor import KMAJOR_TYPES, dequant_kmajor_jnp
from tpullm.quant.numpy_impl import quant_supported
from tpullm.utils.synth import random_payload
from tpullm_torch.ops.qmm import qmm, qmm_plain
from tpullm_torch.ops.qtensor import QTensor, qtensor_from_bytes
from tpullm_torch.quant.kmajor import dequant_kmajor_torch

torch.set_num_threads(2)

KM_TYPES = sorted(KMAJOR_TYPES, key=lambda t: t.name)


def _raw(qtype, N, K, seed=0):
    """GGUF payload bytes of an (N, K) weight: quantized from floats where
    the JAX package has an encoder, else a random valid payload."""
    rng = np.random.default_rng(seed)
    if qtype in quant_supported():
        from tpullm.quant import quantize

        w = (rng.standard_normal((N, K)) * 0.02).astype(np.float32)
        return quantize(w, qtype).reshape(-1)
    return random_payload(qtype, N, K, rng).reshape(-1)


def _t(data):
    return {k: torch.from_numpy(np.array(v)) for k, v in data.items()}


@pytest.mark.parametrize("qtype", KM_TYPES)
def test_dequant_kmajor_bit_exact(qtype):
    """Same f32 operations in the same order: bit-exact, no tolerance."""
    N, K = 64, 512
    km = jfrom_bytes(_raw(qtype, N, K), qtype, (N, K), False, "kmajor")
    want = np.asarray(dequant_kmajor_jnp({k: jnp.asarray(v) for k, v in km.data.items()},
                                         qtype, jnp.float32))
    got = dequant_kmajor_torch(_t(km.data), qtype, torch.float32).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q4_0, GGMLType.Q8_0])
def test_repack_equals_jax(qtype):
    """The port's copy of the numpy pack path gives the JAX arrays exactly."""
    N, K = 300, 1024
    raw = _raw(qtype, N, K, seed=3)
    want = jfrom_bytes(raw, qtype, (N, K), False, "kmajor")
    got = qtensor_from_bytes(raw, qtype, (N, K))
    assert got.layout == "kmajor" and got.shape == want.shape
    assert set(got.data) == set(want.data)
    for k, v in want.data.items():
        np.testing.assert_array_equal(got.data[k].numpy(), np.asarray(v), err_msg=k)


def _nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / max((b ** 2).mean(), 1e-30))


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K])
@pytest.mark.parametrize("M", [1, 7, 32, 64])
@pytest.mark.parametrize("stacked", [False, True])
def test_qmm_plain_vs_pallas(qtype, M, stacked):
    """M in {1, 7, 32} is kernel A's regime (padded M <= 32; 32 its top),
    64 kernel B's.
    The Pallas kernels round the dequantized tile to bf16; the plain
    version (f32 out) keeps f32 weights: NMSE < 5e-5, the bound
    tests/test_qmm.py holds the kernels to against the f32 oracle. Against
    the JAX package's own plain path (dequant + dot) the difference is f32
    summation order only: NMSE < 1e-10."""
    N, K, L = 384, 512, 3
    kms = [jfrom_bytes(_raw(qtype, N, K, seed=s), qtype, (N, K), False, "kmajor")
           for s in range(L if stacked else 1)]
    data = ({k: np.stack([np.asarray(t.data[k]) for t in kms]) for k in kms[0].data}
            if stacked else {k: np.asarray(v) for k, v in kms[0].data.items()})
    layer = 1 if stacked else None
    x = np.random.default_rng(M).standard_normal((M, K)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jqmm_kmajor(
        xb, {k: jnp.asarray(v) for k, v in data.items()}, qtype, N, jnp.float32,
        interpret=True, layer=None if layer is None else jnp.int32(layer)))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = qmm_plain(xt, _t(data), qtype, N, torch.float32, layer).numpy()
    assert got.shape == want.shape == (M, N)
    assert _nmse(got, want) < 5e-5

    shape = ((L,) if stacked else ()) + (N, K)
    jq = JQTensor(qtype, shape, {k: jnp.asarray(v) for k, v in data.items()})
    xf = jnp.asarray(x)
    ref = np.asarray(jqmm(xf, jq, jnp.float32,
                          layer=None if layer is None else jnp.int32(layer)))
    port = qmm(torch.from_numpy(x), QTensor(qtype, shape, _t(data)), torch.float32, layer)
    assert _nmse(port.numpy(), ref) < 1e-10


def test_take_rows_matches_dequant():
    qtype = GGMLType.Q4_K
    N, K = 300, 512
    qt = qtensor_from_bytes(_raw(qtype, N, K), qtype, (N, K))
    idx = torch.tensor([[0, 5], [299, 17]])
    got = qt.take_rows(idx, torch.float32)
    ref = qt.dequant(torch.float32)[idx]
    assert torch.equal(got, ref)
