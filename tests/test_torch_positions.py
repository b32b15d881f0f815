"""The decoders without RoPE in the port held against the JAX package on the
CPU: learned absolute positions (gpt2, starcoder: ``pos_embd``), bloom's
layernorm on the embedding (``tok_norm`` with its bias), ALiBi (bloom, mpt,
jais from the file's max_alibi_bias; refact from its registry row), mpt's
flat layernorm q/k norms with their biases and jais's gate and up biases on
the gated FFN. Each of the 6 registry rows goes through its arch snapshot
and, at Q4_K K-major widths, through both packages (the port's loader and
the params carried across); a port ServerContext against a JAX one for
bloom (int8 KV) and starcoder (bf16 KV); ALiBi in the einsum path and in
kernels C's and E's plain versions against the JAX ``attention`` at GQA
groups of 1, 8 and 48; the slopes; each row's layer-kernel decision
against the JAX gate; the synth's new draws; and the two places where the
port departs from the JAX package (the context shift of a model without
RoPE, the bound of the position table), pinned.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_positions.py -q
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGMLType
from tpullm.gguf.writer import GGUFWriter
from tpullm.models.config import ModelConfig as JConfig
from tpullm.models.llama import KVCache as JKVCache
from tpullm.models.llama import _kv_quant as j_kv_quant
from tpullm.models.llama import alibi_slopes as j_alibi_slopes
from tpullm.models.llama import attention as j_attention
from tpullm.ops.layer_kernel import supported as jblock_supported
from tpullm.ops.qtensor import QTensor as JQTensor
from tpullm.runtime.engine import InferenceEngine as JEngine
from tpullm.runtime.loader import load_model as jload
from tpullm.runtime.memory import _context_shift as j_context_shift
from tpullm.server.context import GenParams as JGenParams
from tpullm.server.context import ServerContext as JServerContext
from tpullm.server.context import Task as JTask
from tpullm.utils.synth import build_arch_gguf
from tpullm_torch.models.config import ModelConfig
from tpullm_torch.models.llama import KVCache, _kv_quant, check_dense, forward, layer_routes
from tpullm_torch.ops.flash_attention import alibi_slopes, flash_attention, masked_attention
from tpullm_torch.ops.flash_decode import flash_decode
from tpullm_torch.ops.qtensor import QTensor
from tpullm_torch.runtime.engine import InferenceEngine
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.runtime.memory import _context_shift
from tpullm_torch.server.context import GenParams, ServerContext, Task
from tpullm_torch.utils.from_jax import params_from_numpy
from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

torch.set_num_threads(2)

SNAP_DIR = os.path.join(os.path.dirname(__file__), "snapshots")
POSITION_ARCHS = ["gpt2", "starcoder", "bloom", "mpt", "jais", "refact"]
PROMPTS = [[3, 9, 4, 17, 6], [5, 1, 2], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 2, 3, 4, 5,
                                         6, 7, 8, 9, 30]]
KMAJOR = dict(n_embd=512, n_head=4, n_head_kv=2, n_ff=512, qtype=GGMLType.Q4_K, seed=11)


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


@pytest.mark.parametrize("arch", POSITION_ARCHS)
def test_arch_snapshot(arch, tmp_path):
    """tests/snapshots/{arch}.npz (the JAX package's golden, from
    build_arch_gguf(seed=11): Q8_0 at n_embd 64, so planar weights) through
    the port's loader and engine on the CPU in f32, with the bar of
    tests/test_arch_snapshots.py:69-73."""
    path = str(tmp_path / f"{arch}.gguf")
    build_arch_gguf(path, arch, seed=11)
    cfg, params, _ = load_model(path, device="cpu")
    assert cfg.arch == arch and not cfg.use_rope
    assert cfg.alibi_max_bias == (0.0 if arch in ("gpt2", "starcoder") else 8.0)
    eng = InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                          decode_chunk=4, device="cpu")
    r = eng.generate([[3, 9, 4, 17, 6]], max_new_tokens=8, return_logits=True)
    snap = np.load(os.path.join(SNAP_DIR, f"{arch}.npz"))
    nmse = _nmse(np.asarray(r.logits[0], np.float32), snap["logits"])
    assert nmse < 1e-6, (arch, nmse)
    assert (np.asarray(r.tokens[0]) == snap["tokens"]).mean() >= 0.75


@pytest.fixture(scope="module")
def kmajor_models(tmp_path_factory):
    """{arch: (path, JAX cfg, JAX params, JAX result of PROMPTS)}: each arch
    at K-major widths, Q4_K, generated once by the JAX engine."""
    out = {}
    d = tmp_path_factory.mktemp("positions")
    for arch in POSITION_ARCHS:
        path = str(d / f"{arch}.gguf")
        build_arch_gguf(path, arch, **KMAJOR)
        jcfg, jparams, _ = jload(path)
        jr = JEngine(jcfg, jparams, max_seq_len=64, compute_dtype=jnp.float32,
                     decode_chunk=4).generate(PROMPTS, max_new_tokens=8, return_logits=True)
        out[arch] = (path, jcfg, jparams, jr)
    return out


@pytest.mark.parametrize("via", ["loader", "params_from_numpy"])
@pytest.mark.parametrize("arch", POSITION_ARCHS)
def test_kmajor_generate_matches_jax(kmajor_models, arch, via):
    """First-step logits at NMSE < 1e-6 and identical greedy tokens (both
    sides run the plain f32 path), the weights K-major as the kernels take
    them, the position table, the embedding's layernorm, the flat q/k norm
    biases and the gate bias of the file carried across."""
    path, jcfg, jparams, jr = kmajor_models[arch]
    if via == "loader":
        cfg, params, _ = load_model(path, device="cpu")
    else:
        cfg, params = params_from_numpy(dataclasses.asdict(jcfg), _flatten(jparams),
                                        device="cpu")
    fields = lambda c: {k: v for k, v in dataclasses.asdict(c).items() if k != "raw_kv"}
    assert fields(cfg) == fields(jcfg)
    layers = params["layers"]
    assert set(layers) == set(jparams["layers"])
    for k in ("pos_embd", "tok_norm", "tok_norm_b", "output_norm_b"):
        assert (k in params) == (k in jparams), k
    assert layers.get("wqkv", layers.get("wqkv_cat")).layout == "kmajor"
    r = InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                        decode_chunk=4, device="cpu").generate(
        PROMPTS, max_new_tokens=8, return_logits=True)
    nmse = _nmse(r.logits, jr.logits)
    assert nmse < 1e-6, nmse
    assert r.tokens == jr.tokens


# -------------------------------------------------------------------- server

def _serve(ctx, task_cls, params_cls, prompts, n_new=8):
    """Greedy requests, all submitted at once; then a follow-up in slot 0
    extending the first prompt and its completion. -> [(tokens, cached)]."""
    gp = lambda: params_cls(max_tokens=n_new, temperature=0.0, ignore_eos=True)
    tasks = [task_cls(tokens=list(p), params=gp()) for p in prompts]
    for t in tasks:
        ctx.submit(t)
    ctx.start()
    try:
        out = []
        for t in tasks:
            done = [p for k, p in t.events() if k == "done"]
            assert done, "task failed"
            out.append((done[0]["tokens"], done[0]["stats"]["cached_tokens"]))
        r = ctx.generate(list(prompts[0]) + out[0][0] + [42, 43], gp())
        out.append((r["tokens"], r["stats"]["cached_tokens"]))
    finally:
        ctx.stop()
    return out


@pytest.mark.parametrize("arch,kv", [("bloom", "q8"), ("starcoder", "bf16")])
def test_server_context_matches_jax(kmajor_models, arch, kv):
    """Identical greedy tokens and prefix reuse from the port's and the JAX
    package's ServerContext (token ids, f32 compute, 2 slots, decode chunks
    of 4, prefill chunks of 32, prompts of 70, 45 and 12 tokens): bloom
    (ALiBi, the embedding's layernorm) on the int8 cache, starcoder (the
    position table) on the bf16 cache."""
    path, jcfg, jparams, _ = kmajor_models[arch]
    cfg, params, _ = load_model(path, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 250, n).tolist() for n in (70, 45, 12)]
    common = dict(n_slots=2, max_seq_len=256, decode_chunk=4, prefill_chunk=32)
    jctx = JServerContext(jcfg, jparams, None, compute_dtype=jnp.float32,
                          kv_dtype={"bf16": jnp.bfloat16, "q8": "q8"}[kv], **common)
    tctx = ServerContext(cfg, params, None, compute_dtype=torch.float32,
                         kv_dtype={"bf16": torch.bfloat16, "q8": "q8"}[kv], device="cpu",
                         **common)
    want = _serve(jctx, JTask, JGenParams, prompts)
    got = _serve(tctx, Task, GenParams, prompts)
    assert got == want
    assert all(len(toks) == 8 for toks, _ in got)


# ------------------------------------------------------------------- ALiBi

@pytest.mark.parametrize("n_head", [12, 32, 40, 48])
def test_alibi_slopes_match_jax(n_head):
    """The port's copy of the slope schedule equals the JAX function, the
    non-power-of-two head counts (12, 40, 48: the second geometric series)
    among them."""
    got = alibi_slopes(n_head, 8.0)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, j_alibi_slopes(n_head, 8.0))


def _attn_case(G, T, S=512, B=2, D=64, seed=0):
    """numpy inputs of one ALiBi attention call: Hkv = 4 // min(G, 4) kv
    heads of G query heads each, T consecutive query slots per row from a
    slot past 200, valid_from 0 and 37."""
    rng = np.random.default_rng(seed + G + T)
    Hkv = max(1, 4 // G)
    H = G * Hkv
    q = (rng.standard_normal((B, T, H, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, Hkv, S, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, Hkv, S, D)) * 0.5).astype(np.float32)
    first = np.array([S - T - 3, 200], np.int64)[:B]
    q_slots = first[:, None] + np.arange(T)[None, :]
    vf = np.array([0, 37], np.int64)[:B]
    positions = q_slots - vf[:, None]
    return q, k, v, q_slots, vf, positions


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("T", [1, 128])
@pytest.mark.parametrize("G", [1, 8, 48])
def test_alibi_attention_matches_jax(G, T, kv):
    """With alibi_max_bias 8, the einsum path (masked_attention), kernel C's
    plain version (flash_attention on CPU tensors) and kernel E's plain
    version (flash_decode on CPU tensors: int8 rows with their scales, or
    bf16) against the JAX package's attention (its einsum path, where every
    ALiBi call goes) on the same bf16 views (dequantized for int8): NMSE <
    1e-6 for the einsum path and C (the same arithmetic), < 1e-4 for E (p
    rounded to bf16 before normalization), as tests/test_torch_flash_decode.py
    bounds it. The bias is really there: without it the output moves."""
    q, k, v, qs, vf, pos = _attn_case(G, T)
    B, _, H, D = q.shape
    S = k.shape[2]
    d = dict(arch="bloom", vocab_size=64, n_embd=H * D, n_layer=1, n_head=H,
             n_head_kv=k.shape[1], n_ff=64, head_dim=D, head_dim_v=D, use_rope=False,
             alibi_max_bias=8.0)
    jcfg, cfg = JConfig(**d), ModelConfig(**d)
    jq = jnp.asarray(q, jnp.bfloat16)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    scales = None
    if kv == "int8":
        kq, ks = j_kv_quant(jk)
        vq, vs = j_kv_quant(jv)
        jk = (kq.astype(jnp.float32) * ks[..., None]).astype(jnp.bfloat16)
        jv = (vq.astype(jnp.float32) * vs[..., None]).astype(jnp.bfloat16)
        scales = tuple(torch.from_numpy(np.array(a)) for a in (kq, vq, ks, vs))
    kvp = np.arange(S)[None, :] - vf[:, None]
    ref = np.asarray(j_attention(jq, jk, jv, jnp.asarray(qs), jnp.asarray(kvp),
                                 jnp.asarray(pos), jnp.asarray(vf), jcfg).astype(jnp.float32))
    tk = torch.from_numpy(np.array(jk.astype(jnp.float32))).to(torch.bfloat16)
    tv = torch.from_numpy(np.array(jv.astype(jnp.float32))).to(torch.bfloat16)
    tqs, tvf, tpos, tkvp = (torch.from_numpy(a) for a in (qs, vf, pos, kvp))
    slopes = torch.from_numpy(alibi_slopes(H, 8.0))
    scale = 1.0 / np.sqrt(D)
    einsum = masked_attention(tq, tk, tv, tqs, tkvp, tpos, tvf, scale, slopes=slopes)
    assert _nmse(einsum.float(), ref) < 1e-6
    plain_c = flash_attention(tq, tk, tv, tqs, tkvp, tpos, tvf, cfg)
    assert _nmse(plain_c.float(), ref) < 1e-6
    if scales is None:
        plain_e = flash_decode(tq, tk, tv, tqs, tpos, tvf, cfg)
    else:
        kq, vq, ks, vs = scales
        plain_e = flash_decode(tq, kq, vq, tqs, tpos, tvf, cfg, k_scales=ks, v_scales=vs)
    assert _nmse(plain_e.float(), ref) < 1e-4
    bare = masked_attention(tq, tk, tv, tqs, tkvp, tpos, tvf, scale)
    assert _nmse(bare.float(), ref) > 1e-3


@pytest.mark.parametrize("field,value", [("sliding_window", 64), ("attn_logit_softcap", 30.0)])
def test_alibi_with_window_or_softcap_raises(field, value):
    """ALiBi runs alone in the port: with a window (and so with a ring) or a
    softcap, which no arch of the JAX registry combines with it, the config
    raises in check_dense rather than being routed."""
    cfg = ModelConfig(arch="bloom", use_rope=False, alibi_max_bias=8.0)
    check_dense(cfg)
    with pytest.raises(NotImplementedError, match="alibi_max_bias"):
        check_dense(dataclasses.replace(cfg, **{field: value}))


# --------------------------------------------------------------------- gates

# (use_block, use_fold) of a decode step (B = 4, T = 1) on the card: refact
# (RMS norm, gated silu, no biases) takes the layer kernel, folded; the
# layernorm rows do not
GATES = dict({a: (False, False) for a in POSITION_ARCHS}, refact=(True, True))


@pytest.mark.parametrize("arch", POSITION_ARCHS)
def test_layer_routes_match_jax_gate(arch, tmp_path):
    """The port's decode-block and fold choices (layer_routes) equal the
    table above and the JAX package's conditions (llama.py:1382-1423, the
    TPU backend taken as present), evaluated on the JAX package's own
    params of the same GGUF; a prefill (T = 512) and the CPU take neither."""
    path = str(tmp_path / f"{arch}.gguf")
    build_arch_gguf(path, arch, **KMAJOR)
    jcfg, jparams, _ = jload(path)
    jgl = jparams["layers"]
    jqw = {k: v for k, v in jgl.items() if isinstance(v, JQTensor)}
    j_block = ("ffn_norm" in jgl and "ffn_norm_b" not in jgl
               and not any(k in jgl for k in ("bo", "ffn_up_b", "ffn_down_b", "ffn_gate_b",
                                               "attn_norm_2"))
               and not jcfg.attn_bias and not jcfg.attn_qk_norm_flat
               and jcfg.kv_lora_rank == 0 and not jcfg.altup_n
               and not any(k.startswith("lora_") for k in jgl)
               and jblock_supported(jcfg, jqw))
    j_fold = (j_block and "wqkv" in jqw and "attn_norm" in jgl
              and not jcfg.no_rope_interval)
    cfg, params, _ = load_model(path, device="cpu")
    gl = params["layers"]
    qw = {k: v for k, v in gl.items() if isinstance(v, QTensor)}
    assert layer_routes(cfg, gl, qw, 4, 1, True, 1) == GATES[arch] == (j_block, j_fold)
    assert layer_routes(cfg, gl, qw, 1, 512, True, 1) == (False, False)
    assert layer_routes(cfg, gl, qw, 4, 1, False, 1) == (False, False)


# ----------------------------------------------------- refusals and the synth

def _with_tensors(tmp_path, monkeypatch, arch, extra):
    """build_arch_gguf of ``arch`` with ``extra`` {name: f32 array} tensors."""
    write = GGUFWriter.write

    def write_extra(self):
        for name, arr in extra.items():
            self.add_tensor(name, arr)
        return write(self)

    monkeypatch.setattr(GGUFWriter, "write", write_extra)
    path = str(tmp_path / f"{arch}.gguf")
    build_arch_gguf(path, arch, seed=11)
    return path


def _forward(cfg, params, prompt=(3, 9, 4, 17, 6)):
    tok = torch.tensor([list(prompt)])
    pos = torch.arange(len(prompt))[None]
    cache = KVCache.create(cfg, 1, 64, torch.float32, "cpu")
    return forward(params, cfg, tok, pos, cache, 0, torch.zeros(1, dtype=torch.int64),
                   torch.float32)[0]


@pytest.mark.parametrize("arch,name,n,what", [
    ("gpt2", "blk.0.ffn_gate.bias", 96, "ffn_gate_b"),
    ("llama", "blk.0.attn_q_norm.bias", 64, "q_norm_b"),
    ("llama", "token_embd_norm.weight", 64, "tok_norm_b"),
    ("qwen3moe", "blk.0.ffn_gate.bias", 64, "ffn_gate_b")])
def test_unread_tensor_raises(tmp_path, monkeypatch, arch, name, n, what):
    """A tensor the config's graph does not read raises in forward (the JAX
    package would ignore it): a gate bias on an ungated FFN or a MoE layer,
    a q norm bias without flat layernorm q/k norms, the embedding norm's
    bias on an RMS-norm model (its file carrying the weight and the bias)."""
    extra = {name: np.ones(n, np.float32)}
    if name == "token_embd_norm.weight":
        extra["token_embd_norm.bias"] = np.ones(n, np.float32)
    path = _with_tensors(tmp_path, monkeypatch, arch, extra)
    cfg, params, _ = load_model(path, device="cpu")
    with pytest.raises(NotImplementedError, match=what):
        _forward(cfg, params)


def test_synth_position_rows():
    """synth_kmajor_q4k_fast for the rows without RoPE: starcoder at one kv
    head (MQA) with an n_ctx-row f32 position table, bloom with ALiBi from
    cfg_fields and the embedding's layernorm and bias; the draws before them
    unchanged; a finite forward on the CPU that the new arrays change."""
    kw = dict(vocab_size=300, n_embd=256, n_layer=2, n_head=4, n_ff=512, seed=3,
              centred=True, device="cpu", exact_vocab=True, tied=True)
    cfg, params = synth_kmajor_q4k_fast(arch="starcoder", n_head_kv=1, n_ctx=48,
                                        cfg_fields=dict(norm_eps=1e-5), **kw)
    _, base = synth_kmajor_q4k_fast(arch="starcoder", n_head_kv=1,
                                    cfg_fields=dict(norm_eps=1e-5), **kw)
    assert not cfg.use_rope and cfg.alibi_max_bias == 0 and cfg.n_head_kv == 1
    assert params["pos_embd"].shape == (48, 256) and params["pos_embd"].dtype == torch.float32
    assert "pos_embd" not in base and "tok_norm" not in params
    for k, v in base["layers"].items():
        assert torch.equal(v, params["layers"][k]) if torch.is_tensor(v) else all(
            torch.equal(a, params["layers"][k].data[n]) for n, a in v.data.items()), k
    lg = _forward(cfg, params)
    assert lg.shape == (1, 5, 300) and torch.isfinite(lg).all()
    assert _nmse(_forward(cfg, base), lg) > 1e-6

    cfg, params = synth_kmajor_q4k_fast(arch="bloom", n_head_kv=4, tok_norm=True,
                                        cfg_fields=dict(norm_eps=1e-5, alibi_max_bias=8.0),
                                        **kw)
    assert not cfg.use_rope and cfg.alibi_max_bias == 8.0 and cfg.attn_bias
    assert {"tok_norm", "tok_norm_b"} <= set(params) and "pos_embd" not in params
    lg = _forward(cfg, params)
    assert torch.isfinite(lg).all()
    bare = {k: v for k, v in params.items() if k not in ("tok_norm", "tok_norm_b")}
    assert _nmse(_forward(cfg, bare), lg) > 1e-6


# --------------------------------------------------- departures from the JAX package

@pytest.mark.parametrize("kv", ["bf16", "q8"])
def test_context_shift_moves_rows_without_rope(kv):
    """On a model without RoPE the port's context shift moves the slot's K
    and V rows (and an int8 cache's row scales) bit for bit and rotates
    nothing, as llama.cpp shifts K only when the rope type is not NONE. The
    JAX package's shift rotates the moved K rows by RoPE all the same
    (memory.py:301-311), pinned here as it computes: its K differs from the
    moved rows, its V (not rotated) does not (ROADMAP §3)."""
    d = dict(arch="starcoder", n_layer=2, n_head=4, n_head_kv=2, head_dim=64, head_dim_v=64,
             use_rope=False, norm_type="layernorm", act_fn="gelu", ffn_gate=False,
             attn_bias=True)
    cfg, jcfg = ModelConfig(**d), JConfig(**d)
    rng = np.random.default_rng(3)
    shape = (2, 3, 2, 64, 64)  # (L, slots, Hkv, S, D)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    slot, n_keep, nd, n_past = 1, 4, 10, 40
    if kv == "q8":
        (kq, ks), (vq, vs) = (_kv_quant(torch.from_numpy(a)) for a in (k, v))
        cache = KVCache(kq, vq, ks, vs)
    else:
        cache = KVCache(*(torch.from_numpy(a).to(torch.bfloat16) for a in (k, v)))
    old = [None if t is None else t.clone() for t in (cache.k, cache.v, cache.ks, cache.vs)]
    _context_shift(cache, cfg, slot, n_keep, nd, n_past)
    for new, was in zip((cache.k, cache.v, cache.ks, cache.vs), old):
        if was is None:
            continue
        assert torch.equal(new[:, slot, :, n_keep:n_past - nd], was[:, slot, :, n_keep + nd:n_past])
        assert torch.equal(new[:, slot, :, :n_keep], was[:, slot, :, :n_keep])
        assert torch.equal(new[:, slot, :, n_past - nd:], was[:, slot, :, n_past - nd:])
        for other in (0, 2):
            assert torch.equal(new[:, other], was[:, other])
    jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (k, v))
    jnew = j_context_shift(JKVCache(jk, jv), jnp.int32(slot), jnp.int32(n_keep),
                           jnp.int32(nd), jnp.int32(n_past), cfg=jcfg)
    moved = lambda a: np.asarray(a[:, slot, :, n_keep:n_past - nd].astype(jnp.float32))
    was_k = np.asarray(jk[:, slot, :, n_keep + nd:n_past].astype(jnp.float32))
    was_v = np.asarray(jv[:, slot, :, n_keep + nd:n_past].astype(jnp.float32))
    assert not np.array_equal(moved(jnew.k), was_k)
    np.testing.assert_array_equal(moved(jnew.v), was_v)


def _starcoder_table(n_ctx):
    return synth_kmajor_q4k_fast(arch="starcoder", vocab_size=300, n_embd=256, n_layer=1,
                                 n_head=4, n_head_kv=1, n_ff=256, seed=3, centred=True,
                                 device="cpu", exact_vocab=True, n_ctx=n_ctx,
                                 cfg_fields=dict(norm_eps=1e-5))


def test_position_table_bound():
    """A model with a learned position table refuses, where an engine or a
    server is built, a context longer than the table; the JAX package
    builds with any context and reads NaN rows past the table (jnp.take),
    where the port's gather would fault on the card (ROADMAP §3). With the
    context at the table's rows and the default decode chunk, generate
    fills the cache to its last slot and gives the tokens of a run in
    chunks of 4."""
    cfg, params = _starcoder_table(33)
    for build in (lambda n: InferenceEngine(cfg, params, max_seq_len=n, device="cpu"),
                  lambda n: ServerContext(cfg, params, None, n_slots=1, max_seq_len=n,
                                          device="cpu")):
        with pytest.raises(ValueError, match="position table"):
            build(64)
        build(33)
    table = jnp.asarray(params["pos_embd"].numpy())
    assert np.isnan(np.asarray(jnp.take(table, jnp.array([33]), axis=0))).all()

    cfg, params = _starcoder_table(48)
    prompts = [[1] * 30, [2] * 5]
    eng = lambda chunk: InferenceEngine(cfg, params, max_seq_len=48, decode_chunk=chunk,
                                        compute_dtype=torch.float32, device="cpu")
    r = eng(32).generate(prompts, max_new_tokens=40)
    assert [len(t) for t in r.tokens] == [17, 17]  # capped at the cache's last slot
    assert r.tokens == eng(4).generate(prompts, max_new_tokens=40).tokens


def test_position_table_reuse_at_its_end():
    """A prefix reuse that ends near the table's end: the follow-up reuses
    57 slots and its 5 pending tokens are padded to a bucket of 8, at
    positions 57-64 of a 64-row table. The gather clamps position 64 (a
    padding row, thrown away), so the request is served, with the tokens
    of a fresh server that prefills the whole prompt."""
    cfg, params = _starcoder_table(64)
    rng = np.random.default_rng(5)
    first = rng.integers(1, 250, 53).tolist()
    gp = lambda n: GenParams(max_tokens=n, temperature=0.0, ignore_eos=True)
    ctx = lambda: ServerContext(cfg, params, None, n_slots=1, max_seq_len=64,
                                compute_dtype=torch.float32, device="cpu")
    warm = ctx()
    warm.start()
    try:
        out = warm.generate(first, gp(4))["tokens"]
        follow = first + out + rng.integers(1, 250, 5).tolist()
        r = warm.generate(follow, gp(1))
    finally:
        warm.stop()
    assert r["stats"]["cached_tokens"] == 57 and len(follow) == 62
    fresh = ctx()
    fresh.start()
    try:
        want = fresh.generate(follow, gp(1))
    finally:
        fresh.stop()
    assert want["stats"]["cached_tokens"] == 0
    assert r["tokens"] == want["tokens"] and len(r["tokens"]) == 1
