"""The MoE router's selection bias and leading dense layers in the port,
held against the JAX package on the CPU: moe_ffn with moe_probs_b (softmax
and sigmoid gating, renormalized or not, scaled) against the JAX moe_ffn,
the bias changing the top-k on most rows; ERNIE-4.5-MoE- and GLM-4.5-shaped
models (3 layers, a dense lead of 1, the bias, a shared expert; glm4moe's
FFN norm under its post_attention_norm name and a NextN block past its
layers) at Q4_K K-major widths through the loader and params_from_numpy
against the JAX engine, and through a ServerContext against the JAX one;
qwen3vl, hunyuan-moe and phimoe (rows that run as they are) at those
widths against the JAX engine; each of the 21 new rows' layer-kernel gate;
the two new keys against the JAX parser; the synth's dense lead, bias and
ungated shared expert. Inputs are drawn with numpy and handed to both
packages.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_moe_bias.py -q
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpullm_torch.models.llama as llama
from tpullm.gguf.constants import GGMLType
from tpullm.gguf.reader import GGUFFile as JGGUFFile
from tpullm.gguf.writer import GGUFWriter
from tpullm.models.config import ModelConfig as JConfig
from tpullm.models.config import config_from_gguf as jconfig_from_gguf
from tpullm.models.llama import moe_ffn as jmoe_ffn
from tpullm.ops.layer_kernel import supported as jblock_supported
from tpullm.ops.qtensor import QTensor as JQTensor
from tpullm.ops.qtensor import qtensor_from_float
from tpullm.runtime.engine import InferenceEngine as JEngine
from tpullm.runtime.loader import _stack_qtensors
from tpullm.runtime.loader import load_model as jload
from tpullm.server.context import GenParams as JGenParams
from tpullm.server.context import ServerContext as JServerContext
from tpullm.server.context import Task as JTask
from tpullm.utils.synth import build_arch_gguf
from tpullm_torch.gguf.reader import GGUFFile
from tpullm_torch.models.config import ModelConfig, config_from_gguf
from tpullm_torch.models.llama import KVCache, forward, layer_routes, moe_ffn
from tpullm_torch.models.registry import ARCH_REGISTRY
from tpullm_torch.ops.qtensor import QTensor
from tpullm_torch.runtime.engine import InferenceEngine
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.server.context import GenParams, ServerContext, Task
from tpullm_torch.utils.from_jax import params_from_numpy

torch.set_num_threads(2)

PROMPTS = [[3, 9, 4, 17, 6], [5, 1, 2], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 2, 3, 4, 5,
                                         6, 7, 8, 9, 30]]
E, USED, D, NFF = 8, 2, 512, 512


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


def _port(jq):
    """JAX QTensor -> port QTensor (same arrays)."""
    return QTensor(GGMLType(int(jq.qtype)), tuple(jq.shape),
                   {k: torch.from_numpy(np.array(v)) for k, v in jq.data.items()})


# ------------------------------------------------------------ the MoE FFN

def _stack(rng, n, k, lead=(E,)):
    """A 2-layer stack of Q4_K (lead..., n, k) weights, as the JAX loader
    stacks them."""
    per = [qtensor_from_float((rng.standard_normal(lead + (n, k)) * 0.05).astype(np.float32),
                              GGMLType.Q4_K, device_put=False) for _ in range(2)]
    return _stack_qtensors(per, device_put=False)


@functools.lru_cache(maxsize=1)
def _bias_layer(seed):
    """(JAX qw, port qw, the selection bias (2, E)) of a 2-layer MoE stack
    of 8 experts with an ungated shared expert, as ERNIE-4.5's files have."""
    rng = np.random.default_rng(seed)
    router = (rng.standard_normal((2, E, D)) * 0.1).astype(np.float32)
    jqw = {"moe_gate_inp": qtensor_from_float(router, GGMLType.F32, device_put=False),
           "moe_gate_exps": _stack(rng, NFF, D), "moe_up_exps": _stack(rng, NFF, D),
           "moe_down_exps": _stack(rng, D, NFF), "ffn_gate_shexp": _stack(rng, NFF, D, ()),
           "ffn_up_shexp": _stack(rng, NFF, D, ()), "ffn_down_shexp": _stack(rng, D, NFF, ())}
    bias = (rng.standard_normal((2, E)) * 0.2).astype(np.float32)
    return jqw, {k: _port(v) for k, v in jqw.items()}, bias


def _spy(monkeypatch, module, name):
    """Record what module.name (a top-k) returns on each call."""
    real, seen = getattr(module, name), []

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(out)
        return out

    monkeypatch.setattr(module, name, spy)
    return seen


@pytest.mark.parametrize("T", [5, 24])
@pytest.mark.parametrize("gating,renorm,scale", [("softmax", True, 1.0), ("softmax", False, 2.5),
                                                 ("sigmoid", True, 2.5), ("sigmoid", False, 1.0)])
def test_moe_ffn_selection_bias_matches_jax(monkeypatch, gating, renorm, scale, T):
    """moe_ffn with the layer's moe_probs_b against the JAX moe_ffn on layer
    1, at B*T <= 16 (lax.cond-gated experts there) and above: the same
    top-k picks and NMSE < 1e-10 in f32. The bias is live: it changes the
    top-k set on at least half of the rows, and the combine weights come
    from the unbiased probabilities (the JAX result), not the biased ones."""
    jqw, qw, bias = _bias_layer(3)
    base = dict(arch="ernie4_5-moe", n_embd=D, n_ff=NFF, n_expert=E, n_expert_used=USED,
                expert_gating=gating, expert_weights_norm=renorm, expert_weights_scale=scale)
    jcfg, cfg = JConfig(**base), ModelConfig(**base)
    x = (np.random.default_rng(T).standard_normal((1, T, D)) * 0.5).astype(np.float32)
    jpicks = _spy(monkeypatch, jax.lax, "top_k")
    want = jmoe_ffn(jnp.asarray(x), {"moe_probs_b": jnp.asarray(bias[1])}, jqw, jnp.int32(1),
                    jcfg, jnp.float32)
    picks = _spy(monkeypatch, llama, "top_k")
    xt = torch.from_numpy(x)
    got = moe_ffn(xt, qw, 1, cfg, torch.float32, None, torch.from_numpy(bias[1]))
    unbiased = moe_ffn(xt, qw, 1, cfg, torch.float32)
    top_i, top_free = picks
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jpicks[0][1]))
    changed = (top_i.sort(-1).values != top_free.sort(-1).values).any(-1).float().mean()
    assert changed >= 0.5, float(changed)
    err = _nmse(got.numpy(), np.asarray(want))
    assert err < 1e-10, err
    assert _nmse(unbiased.numpy(), got.numpy()) > 1e-4

    # the same picks with the weights gathered from the biased probabilities
    # give another result: the JAX value pins the unbiased weights
    real_gather = torch.gather

    def biased_gather(t, dim, idx):
        if t.shape[-1] == E and idx.shape[-1] == USED:
            t = t + torch.from_numpy(bias[1])
        return real_gather(t, dim, idx)

    monkeypatch.setattr(torch, "gather", biased_gather)
    wrong = moe_ffn(xt, qw, 1, cfg, torch.float32, None, torch.from_numpy(bias[1]))
    assert _nmse(wrong.numpy(), np.asarray(want)) > 1e-6


# ------------------------------------------------- K-major widths, end to end

ARCHS = ["ernie4_5-moe", "glm4moe"]


def _build(path, arch):
    """3 layers at n_embd 512 (4 experts of 512, top-2, Q4_K K-major), layer
    0 dense (leading_dense_block_count 1), the router's selection bias, an
    ungated shared expert. ernie4_5-moe routes by softmax, as ERNIE-4.5's
    files do (expert_gating_func 1; the synth's hint writes sigmoid);
    glm4moe by sigmoid, with its FFN norm as post_attention_norm, and a
    fourth block that is its NextN layer (nextn_predict_layers 1, with a
    nextn.* tensor no graph reads)."""
    write = GGUFWriter.write

    def write_extra(self):
        if arch == "ernie4_5-moe":
            self.add_uint32("ernie4_5-moe.expert_gating_func", 1)
        else:
            self.add_uint32("glm4moe.nextn_predict_layers", 1)
            self.add_tensor("blk.3.nextn.eh_proj.weight", np.zeros((D, 2 * D), np.float32))
        return write(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(GGUFWriter, "write", write_extra)
        build_arch_gguf(path, arch, n_embd=D, n_layer=3 if arch == "ernie4_5-moe" else 4,
                        n_head=4, n_head_kv=2, n_ff=NFF, qtype=GGMLType.Q4_K, seed=11)
    return path


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{arch: (path, JAX config, params, result of PROMPTS)}."""
    out = {}
    d = tmp_path_factory.mktemp("moe_bias")
    for arch in ARCHS:
        path = _build(str(d / f"{arch}.gguf"), arch)
        jcfg, jparams, _ = jload(path)
        jr = JEngine(jcfg, jparams, max_seq_len=64, compute_dtype=jnp.float32,
                     decode_chunk=4).generate(PROMPTS, max_new_tokens=8, return_logits=True)
        out[arch] = (path, jcfg, jparams, jr)
    return out


@pytest.mark.parametrize("via", ["loader", "params_from_numpy"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_lead_and_bias_generate_matches_jax(models, arch, via):
    """First-step logits at NMSE < 1e-6 and identical greedy tokens (both
    sides the plain f32 path): the dense lead a layer group of its own with
    the fused gate/up, the MoE layers with their f32 selection bias and
    ungated shared expert; glm4moe's FFN norm renamed and its NextN block
    left out. The bias reaches the logits: without it they move."""
    path, jcfg, jparams, jr = models[arch]
    if via == "loader":
        cfg, params, _ = load_model(path, device="cpu")
    else:
        cfg, params = params_from_numpy(dataclasses.asdict(jcfg), _flatten(jparams),
                                        device="cpu")
    fields = lambda c: {k: v for k, v in dataclasses.asdict(c).items() if k != "raw_kv"}
    assert fields(cfg) == fields(jcfg)
    assert (cfg.n_layer, cfg.n_layer_dense_lead) == (3, 1)
    assert cfg.expert_gating == ("softmax" if arch == "ernie4_5-moe" else "sigmoid")
    dense, moe = params["layers"]["__groups__"]
    assert dense["ffn_gateup"].layout == "kmajor" and "moe_gate_inp" not in dense
    assert dense["ffn_norm"].shape == (1, D) and moe["ffn_norm"].shape == (2, D)
    assert "post_attn_norm" not in dense and "moe_gate_inp_shexp" not in moe
    b = moe["moe_probs_b"]
    assert isinstance(b, torch.Tensor) and b.dtype == torch.float32 and b.shape == (2, 4)
    assert moe["moe_gate_exps"].layout == moe["ffn_gate_shexp"].layout == "kmajor"
    r = InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                        decode_chunk=4, device="cpu").generate(
        PROMPTS, max_new_tokens=8, return_logits=True)
    nmse = _nmse(r.logits, jr.logits)
    assert nmse < 1e-6, nmse
    assert r.tokens == jr.tokens
    free = dict(params, layers={"__groups__": [dense, {k: v for k, v in moe.items()
                                                       if k != "moe_probs_b"}]})
    r0 = InferenceEngine(cfg, free, max_seq_len=64, compute_dtype=torch.float32,
                         decode_chunk=4, device="cpu").generate(
        PROMPTS, max_new_tokens=1, return_logits=True)
    assert _nmse(r0.logits, jr.logits) > 1e-8


@pytest.mark.parametrize("arch", ["qwen3vl", "hunyuan-moe", "phimoe"])
def test_as_is_rows_kmajor_generate_matches_jax(arch, tmp_path):
    """Three of the rows that run as they are, at Q4_K K-major widths
    through the loader against the JAX engine: qwen3vl's text path (per-head
    QK norms), hunyuan-moe's gated shared expert without its sigmoid gate,
    phimoe's layernorm MoE. First-step logits at NMSE < 1e-6, identical
    greedy tokens."""
    path = str(tmp_path / f"{arch}.gguf")
    build_arch_gguf(path, arch, n_embd=D, n_head=4, n_head_kv=2, n_ff=NFF,
                    qtype=GGMLType.Q4_K, seed=11)
    jcfg, jparams, _ = jload(path)
    jr = JEngine(jcfg, jparams, max_seq_len=64, compute_dtype=jnp.float32,
                 decode_chunk=4).generate(PROMPTS, max_new_tokens=8, return_logits=True)
    cfg, params, _ = load_model(path, device="cpu")
    assert params["layers"]["wqkv"].layout == "kmajor"
    r = InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                        decode_chunk=4, device="cpu").generate(
        PROMPTS, max_new_tokens=8, return_logits=True)
    assert _nmse(r.logits, jr.logits) < 1e-6
    assert r.tokens == jr.tokens


BURST = [list(range(3, 13)), list(range(40, 52)), [9, 8, 7, 6, 5, 4, 3, 2]]
PAIR = [101, 7, 55, 3, 81, 200]


def _run_server(ctx, task_cls, params_cls, n_new=6):
    """A burst of three greedy requests on two slots, then a sequential pair
    whose second prompt extends the first and its completion. -> [(tokens,
    cached_tokens)]."""
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


@pytest.mark.parametrize("arch,kv", [("ernie4_5-moe", "q8"), ("glm4moe", "f32")])
def test_server_context_matches_jax(models, arch, kv):
    """Identical greedy tokens and prefix reuse from the port's and the JAX
    package's ServerContext (token ids, f32 compute, 2 slots, decode chunks
    of 4, prefill chunks of 8)."""
    path, jcfg, jparams, _ = models[arch]
    cfg, params, _ = load_model(path, device="cpu")
    common = dict(n_slots=2, max_seq_len=64, decode_chunk=4, prefill_chunk=8)
    jctx = JServerContext(jcfg, jparams, None, compute_dtype=jnp.float32,
                          kv_dtype={"f32": jnp.float32, "q8": "q8"}[kv], **common)
    tctx = ServerContext(cfg, params, None, compute_dtype=torch.float32,
                         kv_dtype={"f32": torch.float32, "q8": "q8"}[kv], device="cpu",
                         **common)
    want = _run_server(jctx, JTask, JGenParams)
    got = _run_server(tctx, Task, GenParams)
    assert got == want
    assert all(len(toks) == 6 for toks, _ in got)


# --------------------------------------------------------------- the gates

NEW_ARCHS = ["llama-embed", "qwen2vl", "qwen3vl", "smollm3", "hunyuan_vl", "paddleocr",
             "pangu-embedded", "kimi-linear", "deepseek", "olmoe", "phimoe", "hunyuan-moe",
             "qwen3vlmoe", "ernie4_5-moe", "glm4moe", "deepseek2-ocr", "exaone-moe", "dots1",
             "bailingmoe", "bailingmoe2", "minimax-m2"]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_layer_routes_match_jax_gate(arch, tmp_path):
    """Each new row's decode-block and fold choices (layer_routes), group by
    group, equal the JAX package's conditions (llama.py:1382-1423, the TPU
    backend taken as present) on its own params of the same GGUF: no MoE
    row takes the layer kernel, its dense lead included (the kernel's gate
    refuses any n_expert), and a prefill and the CPU take neither."""
    assert arch in ARCH_REGISTRY
    path = str(tmp_path / f"{arch}.gguf")
    build_arch_gguf(path, arch, n_embd=512, n_head=4, n_head_kv=2, n_ff=512,
                    qtype=GGMLType.Q4_K, seed=11)
    jcfg, jparams, _ = jload(path)
    cfg, params, _ = load_model(path, device="cpu")
    jgroups = jparams["layers"].get("__groups__") or [jparams["layers"]]
    groups = params["layers"].get("__groups__") or [params["layers"]]
    assert len(groups) == len(jgroups) == (2 if cfg.n_layer_dense_lead else 1)
    for jgl, gl in zip(jgroups, groups):
        jqw = {k: v for k, v in jgl.items() if isinstance(v, JQTensor)}
        j_block = ("ffn_norm" in jgl and "ffn_norm_b" not in jgl
                   and not any(k in jgl for k in ("bo", "ffn_up_b", "ffn_down_b",
                                                   "ffn_gate_b", "attn_norm_2"))
                   and not jcfg.attn_bias and not jcfg.attn_qk_norm_flat
                   and jcfg.kv_lora_rank == 0 and not jcfg.altup_n
                   and jblock_supported(jcfg, jqw))
        j_fold = (j_block and "wqkv" in jqw and len(jgroups) == 1 and "attn_norm" in jgl
                  and not jcfg.no_rope_interval)
        qw = {k: v for k, v in gl.items() if isinstance(v, QTensor)}
        got = layer_routes(cfg, gl, qw, 4, 1, True, len(groups))
        assert got == (j_block, j_fold)
        assert not (cfg.n_expert and got[0])
        assert layer_routes(cfg, gl, qw, 1, 512, True, len(groups)) == (False, False)
        assert layer_routes(cfg, gl, qw, 4, 1, False, len(groups)) == (False, False)


# --------------------------------------------------------------- the keys

def test_dense_lead_and_nextn_keys_parse_as_jax(models):
    """leading_dense_block_count and nextn_predict_layers parse as the JAX
    parser reads them (the NextN block off n_layer), and the loader passes
    over the NextN block's tensors, which no graph reads."""
    for arch in ARCHS:
        path = models[arch][0]
        cfg, jcfg = config_from_gguf(GGUFFile(path)), jconfig_from_gguf(JGGUFFile(path))
        assert cfg.n_layer_dense_lead == jcfg.n_layer_dense_lead == 1
        assert cfg.n_layer == jcfg.n_layer == 3
    g = GGUFFile(models["glm4moe"][0])
    assert g.get("glm4moe.block_count") == 4 and "blk.3.nextn.eh_proj.weight" in g.tensors


def test_synth_dense_lead_bias_and_ungated_shared_expert():
    """synth_moe_q4k's new options: the dense lead a group of its own with
    the fused gate/up of n_ff, the attention of both groups cut from one
    draw; the bias (n_moe, E); the shared expert without its gate; the
    draws of the options left at their defaults as before. A forward on the
    CPU runs through them, and the bias moves its logits."""
    from tpullm_torch.utils.synth import synth_moe_q4k

    kw = dict(arch="ernie4_5-moe", vocab_size=300, n_embd=256, n_layer=3, n_head=4,
              n_head_kv=2, n_ff=512, n_expert=8, n_expert_used=2, n_ff_exp=256,
              n_ff_shexp=512, rope_base=5e5, exact_vocab=True, tied=True, seed=4,
              device="cpu")
    cfg, params = synth_moe_q4k(**kw, n_dense_lead=1, probs_b_std=0.05, shexp_gate=False,
                                cfg_fields=dict(expert_weights_norm=True))
    plain_cfg, plain = synth_moe_q4k(**kw)
    assert (cfg.n_layer_dense_lead, cfg.expert_weights_norm, cfg.rope_type) == (1, True, "norm")
    assert cfg.tie_embeddings and params["output"] is params["tok_embd"]
    dense, moe = params["layers"]["__groups__"]
    assert dense["ffn_gateup"].shape == (1, 1024, 256) and dense["ffn_down"].shape == (1, 256, 512)
    assert moe["moe_gate_exps"].shape == (2, 8, 256, 256) and moe["moe_probs_b"].shape == (2, 8)
    assert "moe_gate_inp_shexp" not in moe and moe["ffn_down_shexp"].shape == (2, 256, 512)
    torch.testing.assert_close(dense["wqkv"].data["q"], plain["layers"]["wqkv"].data["q"][:1],
                               rtol=0, atol=0)
    torch.testing.assert_close(moe["wo"].data["d"], plain["layers"]["wo"].data["d"][1:],
                               rtol=0, atol=0)
    assert plain["layers"]["moe_gate_inp_shexp"].shape == (3, 256)
    outs = []
    for p in (params, dict(params, layers={"__groups__": [dense, {
            k: v for k, v in moe.items() if k != "moe_probs_b"}]})):
        cache = KVCache.create(cfg, 1, 16, torch.float32, "cpu")
        tok = torch.tensor([[3, 9, 4, 17]])
        outs.append(forward(p, cfg, tok, torch.arange(4)[None], cache, 0,
                            torch.zeros(1, dtype=torch.int64), torch.float32)[0])
    assert outs[0].shape == (1, 4, 300) and torch.isfinite(outs[0]).all()
    assert not torch.equal(outs[0], outs[1])
