"""The dense singles in the port held against the JAX package on the CPU:
chameleon's per-head layernorm QK norm, apertus's xIELU, bitnet's sub-norms
and per-tensor scales over planar TQ2_0, cogvlm's text path beside its
vision-expert tensors. Their snapshots run in tests/test_torch_arch_flags.py
(SINGLE_ARCHS); here: xIELU against the JAX ffn, the four rows at K-major
widths through the port's loader and the params carried across against the
JAX engine, bitnet's layer with its scales against the JAX layer that reads
them, planar TQ2_0 bit for bit, the layer-kernel gates, the vision tensors'
rule, the xIELU keys and an apertus q8 ServerContext against the JAX one.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_dense_singles.py -q
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGMLType
from tpullm.gguf.writer import GGUFWriter
from tpullm.models import llama as jllama
from tpullm.models.config import ModelConfig as JConfig
from tpullm.ops.dequant import dequant_jax
from tpullm.ops.layer_kernel import supported as jblock_supported
from tpullm.ops.qtensor import QTensor as JQTensor
from tpullm.ops.qtensor import qtensor_from_bytes as jfrom_bytes
from tpullm.quant.numpy_impl import dequantize as np_dequantize
from tpullm.runtime.engine import InferenceEngine as JEngine
from tpullm.runtime.loader import load_model as jload
from tpullm.server.context import GenParams as JGenParams
from tpullm.server.context import ServerContext as JServerContext
from tpullm.server.context import Task as JTask
from tpullm.utils.synth import build_arch_gguf, build_llama_gguf
from tpullm_torch.gguf.constants import GGML_QUANT_SIZES
from tpullm_torch.models.config import ModelConfig, config_from_gguf
from tpullm_torch.models.llama import (SCALE_KEYS, SUB_NORM_KEYS, KVCache, check_dense, ffn,
                                       forward, layer_routes)
from tpullm_torch.ops.qtensor import QTensor, qtensor_from_bytes
from tpullm_torch.runtime.engine import InferenceEngine
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.server.context import GenParams, ServerContext, Task
from tpullm_torch.utils.from_jax import params_from_numpy

torch.set_num_threads(2)

SINGLES = ["chameleon", "apertus", "bitnet", "cogvlm"]
KMAJOR = dict(n_embd=512, n_head=4, n_head_kv=2, n_ff=512, qtype=GGMLType.Q4_K, seed=11)
PROMPTS = [[3, 9, 4, 17, 6], [5, 1, 2], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 2, 3, 4, 5, 6]]


def _nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / max((b ** 2).mean(), 1e-30))


def _flatten(v):
    """JAX params -> the plain nested data params_from_numpy takes."""
    if isinstance(v, JQTensor):
        return {"qtype": int(v.qtype), "shape": tuple(v.shape),
                "data": {k: np.asarray(a) for k, a in v.data.items()}}
    if isinstance(v, dict):
        return {k: _flatten(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_flatten(x) for x in v]
    return np.asarray(v)


def _jax_reads_scales(jparams):
    """The JAX params with bitnet's per-tensor scales as the f32 arrays its
    forward reads (llama.py:616-619, 656-661, 1222-1225, 1262-1263): its
    loader leaves them as F32 weights, which that forward passes over."""
    layers = {k: (jnp.asarray(v.data["w"]) if k in SCALE_KEYS else v)
              for k, v in jparams["layers"].items()}
    return dict(jparams, layers=layers)


@pytest.fixture(scope="module")
def kmajor_models(tmp_path_factory):
    """{arch: (path, JAX config, JAX params, JAX result of PROMPTS)}: each row
    at K-major widths, Q4_K, generated once by the JAX engine (bitnet's with
    its scales read, _jax_reads_scales)."""
    out = {}
    d = tmp_path_factory.mktemp("dense_singles")
    for arch in SINGLES:
        path = str(d / f"{arch}.gguf")
        build_arch_gguf(path, arch, **KMAJOR)
        jcfg, jparams, _ = jload(path)
        if arch == "bitnet":
            jparams = _jax_reads_scales(jparams)
        jr = JEngine(jcfg, jparams, max_seq_len=64, compute_dtype=jnp.float32,
                     decode_chunk=4).generate(PROMPTS, max_new_tokens=8, return_logits=True)
        out[arch] = (path, jcfg, jparams, jr)
    return out


@pytest.mark.parametrize("via", ["loader", "params_from_numpy"])
@pytest.mark.parametrize("arch", SINGLES)
def test_kmajor_generate_matches_jax(kmajor_models, arch, via):
    """First-step logits at NMSE < 1e-6 and identical greedy tokens, both
    sides on the plain f32 path, the weights K-major and fused as the
    kernels take them; the config field for field the JAX parser's
    (apertus's folded xIELU parameters among them). bitnet's scales are read
    on both sides: the port's loader and params_from_numpy hold them as f32
    arrays."""
    path, jcfg, jparams, jr = kmajor_models[arch]
    if via == "loader":
        cfg, params, _ = load_model(path, device="cpu")
    else:
        cfg, params = params_from_numpy(dataclasses.asdict(jcfg), _flatten(jparams),
                                        device="cpu")
    fields = lambda c: {k: v for k, v in dataclasses.asdict(c).items() if k != "raw_kv"}
    assert fields(cfg) == fields(jcfg)
    layers = params["layers"]
    assert layers.get("wqkv", layers.get("wqkv_cat")).layout == "kmajor"
    if arch == "bitnet":
        assert all(layers[k].dtype == torch.float32 and layers[k].shape == (2, 1)
                   for k in SCALE_KEYS)
    r = InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                        decode_chunk=4, device="cpu").generate(
        PROMPTS, max_new_tokens=8, return_logits=True)
    assert _nmse(r.logits, jr.logits) < 1e-6
    assert r.tokens == jr.tokens


def test_bitnet_scales_move_the_logits(kmajor_models):
    """The scales the previous test holds on both sides (0.9 and 0.95 a
    layer, the JAX synth's) are live: the JAX package's own run of the file,
    whose forward passes over them (ROADMAP §3), differs from both."""
    path, jcfg, jparams, jr = kmajor_models["bitnet"]
    raw_cfg, raw_params, _ = jload(path)
    assert isinstance(raw_params["layers"]["wq_s"], JQTensor)
    r = JEngine(raw_cfg, raw_params, max_seq_len=64, compute_dtype=jnp.float32,
                decode_chunk=4).generate(PROMPTS, max_new_tokens=1, return_logits=True)
    assert _nmse([lg[0] for lg in r.logits], [lg[0] for lg in jr.logits]) > 1e-4


def test_bitnet_tq2_0_layer_matches_jax(tmp_path):
    """bitnet at TQ2_0 (every projection planar: K 256 and 512 have no
    K-major tile) with its sub-norms and scales against the JAX forward fed
    the scales as its code reads them: prefill logits at NMSE < 1e-6."""
    path = str(tmp_path / "bitnet_tq2.gguf")
    build_arch_gguf(path, "bitnet", n_embd=256, n_head=2, n_head_kv=1, n_ff=512,
                    qtype=GGMLType.TQ2_0, seed=5)
    jcfg, jparams, _ = jload(path)
    jparams = _jax_reads_scales(jparams)
    cfg, params, _ = load_model(path, device="cpu")
    layers = params["layers"]
    assert {layers[k].layout for k in ("wq", "wk", "wv", "wo", "ffn_gate", "ffn_up",
                                       "ffn_down")} == {"planar"}
    assert layers["wq"].qtype == GGMLType.TQ2_0 and SUB_NORM_KEYS <= set(layers)
    toks = np.asarray([[3, 9, 4, 17, 6, 2]])
    pos = np.arange(6)[None]
    jc = jllama.KVCache.create(jcfg, 1, 16, jnp.float32)
    want, _ = jllama.forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos), jc, 0,
                             jnp.zeros((1,), jnp.int32), jnp.float32)
    c = KVCache.create(cfg, 1, 16, torch.float32, "cpu")
    got, _ = forward(params, cfg, torch.from_numpy(toks), torch.from_numpy(pos), c, 0,
                     torch.zeros(1, dtype=torch.int64), torch.float32)
    assert _nmse(got.numpy(), np.asarray(want)) < 1e-6


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_xielu_matches_jax_ffn(dtype):
    """apertus's ungated FFN against the JAX ffn on identity up and down
    weights (F32), so up's output is the input: values on both sides of 0
    and of eps (-1e-6), far out on both sides, at two layers' parameters
    (the JAX synth's arrays, folded), in f32 and in bf16."""
    from tpullm_torch.utils.synth import jax_synth_xielu

    n, L = 64, 2
    cfg = ModelConfig(arch="apertus", n_embd=n, n_ff=n, n_layer=L, ffn_gate=False,
                      act_fn="xielu", xielu=jax_synth_xielu(L))
    jcfg = JConfig(**dataclasses.asdict(cfg))
    edge = [-30.0, -5.0, -1.0, -1e-3, -2e-6, -1e-6, -5e-7, -1e-9, 0.0, 1e-9, 5e-7, 1e-6,
            1e-3, 0.5, 1.0, 4.0, 30.0]
    rng = np.random.default_rng(0)
    x = np.concatenate([edge, rng.normal(0, 2, 3 * n - len(edge))]).astype(np.float32)
    x = x.reshape(1, 3, n)
    eye = np.broadcast_to(np.eye(n, dtype=np.float32), (L, n, n)).copy()
    tdt, jdt = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    jqw = {k: JQTensor(GGMLType.F32, (L, n, n), {"w": jnp.asarray(eye)})
           for k in ("ffn_up", "ffn_down")}
    tqw = {k: QTensor(GGMLType.F32, (L, n, n), {"w": torch.from_numpy(eye)})
           for k in ("ffn_up", "ffn_down")}
    for li in range(L):
        want = np.asarray(jllama.ffn(jnp.asarray(x).astype(jdt), jqw, li, jcfg, jdt)
                          .astype(jnp.float32))
        got = ffn(torch.from_numpy(x).to(tdt), tqw, li, cfg, tdt).float().numpy()
        if dtype == "f32":
            # expm1(u) - u cancels near 0, where the two libraries' expm1
            # part in their last bit: a few ulp of the result
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
        else:
            assert _nmse(got, want) < 1e-5


def test_planar_tq2_0_bit_for_bit():
    """Planar TQ2_0 (every 2-bit field, 3 included, with random f16 scales)
    dequantizes to the JAX package's dequant_jax and numpy_impl's bits in
    f32, at BitNet's K 2560 and 6912, where no K-major tile fits."""
    blk, bs = GGML_QUANT_SIZES[GGMLType.TQ2_0]
    rng = np.random.default_rng(7)
    for K in (2560, 6912):
        shape = (6, K)
        raw = rng.integers(0, 256, (shape[0], K // blk, bs), dtype=np.uint8)
        raw[..., 64:66] = np.frombuffer(rng.normal(0, 0.05, shape[0] * K // blk)
                                        .astype(np.float16).tobytes(), np.uint8).reshape(
            shape[0], K // blk, 2)
        raw = raw.reshape(-1)
        q = qtensor_from_bytes(raw, GGMLType.TQ2_0, shape)
        jq = jfrom_bytes(raw, GGMLType.TQ2_0, shape, device_put=False)
        assert q.layout == jq.layout == "planar"
        got = q.dequant(torch.float32).numpy()
        want = np.asarray(dequant_jax(jq.data, GGMLType.TQ2_0, jnp.float32)).reshape(shape)
        ref = np_dequantize(raw.reshape(shape[0], -1), GGMLType.TQ2_0).reshape(shape)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        np.testing.assert_array_equal(got.view(np.uint32), ref.astype(np.float32).view(np.uint32))


# (use_block, use_fold) of a decode step (B = 4, T = 1) on the card: chameleon
# takes the kernel folded (its QK norm runs in attention on the emitted
# rows), cogvlm takes it unfolded (the GGUF-fused attn_qkv is no wqkv),
# apertus's ungated xIELU FFN closes it; bitnet's sub-norms and scales keep
# it off, the port's own condition, where the JAX gate takes it
GATES = {"chameleon": ((True, True), (True, True)), "cogvlm": ((True, False), (True, False)),
         "apertus": ((False, False), (False, False)), "bitnet": ((False, False), (True, True))}


@pytest.mark.parametrize("arch", sorted(GATES))
def test_layer_kernel_gates(arch, kmajor_models):
    """layer_routes on the card against the table, and the JAX package's
    conditions (llama.py:1382-1423, the TPU backend taken as present) on its
    own params of the same file; bitnet without its sub-norms and scales
    takes the kernel folded, so those are what keep it off."""
    path, jcfg, _, _ = kmajor_models[arch]
    _, jparams, _ = jload(path)
    jgl = jparams["layers"]
    jqw = {k: v for k, v in jgl.items() if isinstance(v, JQTensor)}
    j_block = ("ffn_norm" in jgl and not any(k in jgl for k in ("bo", "ffn_up_b", "ffn_down_b",
                                                                "ffn_gate_b", "attn_norm_2"))
               and not jcfg.attn_bias and not jcfg.attn_qk_norm_flat
               and jblock_supported(jcfg, jqw))
    j_fold = j_block and "wqkv" in jqw and "attn_norm" in jgl
    cfg, params, _ = load_model(path, device="cpu")
    gl = params["layers"]
    qw = {k: v for k, v in gl.items() if isinstance(v, QTensor)}
    port, jax_gate = GATES[arch]
    assert layer_routes(cfg, gl, qw, 4, 1, True, 1) == port
    assert (j_block, j_fold) == jax_gate
    assert layer_routes(cfg, gl, qw, 4, 1, False, 1) == (False, False)
    if arch == "bitnet":
        bare = {k: v for k, v in gl.items() if k not in SCALE_KEYS | SUB_NORM_KEYS}
        assert layer_routes(cfg, bare, qw, 4, 1, True, 1) == (True, True)


def test_cogvlm_vision_tensors_stay_in_the_file(tmp_path, monkeypatch):
    """cogvlm's five vis_* tensors are passed over: no params key holds them
    and the parameters are those of the file without them; the same names on
    a llama file raise at load."""
    path = str(tmp_path / "cogvlm.gguf")
    build_arch_gguf(path, "cogvlm", seed=3)
    cfg, params, g = load_model(path, device="cpu")
    vis = sorted(t for t in g.tensors if ".vis_" in t)
    assert len(vis) == 5 * cfg.n_layer
    assert not any("vis" in k for k in params["layers"])
    write = GGUFWriter.write

    def write_extra(self):
        self.add_tensor("blk.0.vis_up.weight", np.ones((96, 64), np.float32))
        return write(self)

    monkeypatch.setattr(GGUFWriter, "write", write_extra)
    llama = build_llama_gguf(str(tmp_path / "llama.gguf"), vocab_size=256, n_embd=64,
                             n_layer=1, n_head=4, n_head_kv=2, n_ff=96, seed=1)
    with pytest.raises(NotImplementedError, match="vis_up"):
        load_model(llama, device="cpu")


class _Meta:
    """The metadata face of a GGUF file (config_from_gguf reads no more)."""

    def __init__(self, kv, arch):
        self.architecture = arch
        self.metadata = {"general.architecture": arch, **kv}

    def get(self, key, default=None):
        return self.metadata.get(key, default)


def test_xielu_keys():
    """The four xielu.* arrays parse on apertus as the JAX parser folds them
    (a missing beta and eps take 0.5 and -1e-6; a scalar stands for every
    layer); on any other arch they raise, as does a fifth xielu key on
    apertus; check_dense refuses xIELU parameters without the ungated xIELU
    FFN, and the layernorm QK norm and the sub-norms off their blocks."""
    from tpullm.models.config import config_from_gguf as jconfig_from_gguf

    kv = {"apertus.block_count": 3, "xielu.alpha_n": [0.8, 0.9, 1.0],
          "xielu.alpha_p": [0.8, 0.7, 40.0], "xielu.beta": 0.25}
    cfg = config_from_gguf(_Meta(kv, "apertus"))
    assert cfg.xielu == jconfig_from_gguf(_Meta(kv, "apertus")).xielu
    assert cfg.xielu[2][1] == 40.0 and cfg.xielu[0][3] == -1e-6 and cfg.xielu[1][2] == 0.25
    check_dense(cfg)
    with pytest.raises(NotImplementedError, match="xielu"):
        config_from_gguf(_Meta(dict(kv, **{"llama.block_count": 3}), "llama"))
    with pytest.raises(NotImplementedError, match="xielu.gamma"):
        config_from_gguf(_Meta(dict(kv, **{"xielu.gamma": 1.0}), "apertus"))
    for bad in (dict(xielu=cfg.xielu[:2]), dict(ffn_gate=True), dict(act_fn="gelu")):
        with pytest.raises(NotImplementedError, match="act_fn"):
            check_dense(dataclasses.replace(cfg, **bad))
    cham = ModelConfig(arch="chameleon", attn_qk_norm=True, qk_norm_type="layernorm")
    check_dense(cham)
    with pytest.raises(NotImplementedError, match="qk_norm_type"):
        check_dense(dataclasses.replace(cham, qk_norm_post_rope=True))
    check_dense(ModelConfig(arch="bitnet", sub_norms=True))
    with pytest.raises(NotImplementedError, match="sub_norms"):
        check_dense(ModelConfig(arch="bitnet", sub_norms=True, kv_lora_rank=64, rope_dim=32,
                                head_dim=64))


BURST = [list(range(3, 13)), list(range(40, 52)), [9, 8, 7, 6, 5, 4, 3, 2]]
PAIR = [101, 7, 55, 3, 81, 200]


def _run_server(ctx, task_cls, params_cls, n_new=6):
    """A burst of three greedy requests on two slots (the third waits for a
    slot), then a sequential pair in slot 0 whose second prompt extends the
    first prompt and its completion. -> [(tokens, cached_tokens)]."""
    gp = lambda: params_cls(max_tokens=n_new, temperature=0.0)
    tasks = [task_cls(tokens=list(t), params=gp()) for t in BURST]
    for t in tasks:
        ctx.submit(t)
    ctx.start()
    try:
        out = []
        for t in tasks:
            done = [p for k, p in t.events() if k == "done"]
            assert done, "task failed"
            out.append((done[0]["tokens"], done[0]["stats"]["cached_tokens"]))
        first = ctx.generate(list(PAIR), gp())
        second = ctx.generate(PAIR + first["tokens"] + [42, 43], gp())
        out += [(r["tokens"], r["stats"]["cached_tokens"]) for r in (first, second)]
    finally:
        ctx.stop()
    return out


def test_apertus_server_context_matches_jax(kmajor_models):
    """An apertus q8 ServerContext (token ids, f32 compute, 2 slots, decode
    chunks of 4, prefill chunks of 8) against the JAX one: the same greedy
    tokens and prefix reuse, xIELU's per-layer parameters in every step."""
    path, jcfg, jparams, _ = kmajor_models["apertus"]
    cfg, params, _ = load_model(path, device="cpu")
    common = dict(n_slots=2, max_seq_len=64, decode_chunk=4, prefill_chunk=8)
    jctx = JServerContext(jcfg, jparams, None, compute_dtype=jnp.float32, kv_dtype="q8",
                          **common)
    tctx = ServerContext(cfg, params, None, compute_dtype=torch.float32, kv_dtype="q8",
                         device="cpu", **common)
    want = _run_server(jctx, JTask, JGenParams)
    got = _run_server(tctx, Task, GenParams)
    assert got == want
    assert all(len(toks) == 6 for toks, _ in got)
    assert got[-1][1] >= len(PAIR) and got[-2][1] == 0
