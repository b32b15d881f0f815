"""The other MoE families in the port (dbrx, grok, arctic, grovemoe), held
against the JAX package on the CPU: moe_ffn with GELU experts, grovemoe's
sigmoid selection and its chunk-expert bank (a row naming one chunk twice;
K-major, planar Q8_0 and planar Q5_0 chunk downs) against the JAX moe_ffn;
the chunk bank through the plain versions of the skip and kernel F against
the loop; grok's block with and without its dense FFN and arctic's MoE on
the layer input; each row's K-major file (Q4_K, 2 layers at n_embd 512)
through the loader and params_from_numpy against the JAX engine; a
ServerContext on grovemoe against the JAX one; the renames of dbrx's and
grok's norms; the refusals that remain; planar Q5_0 bit for bit and a Q4_K_M-like
DeepSeek file whose Q5_0 rows load. Inputs are drawn with numpy and handed
to both packages.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_moe_families.py -q
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpullm.utils.synth as jsynth
import tpullm_torch.models.llama as llama
from tpullm.gguf.constants import GGMLType
from tpullm.gguf.writer import GGUFWriter
from tpullm.models.config import ModelConfig as JConfig
from tpullm.models.llama import moe_ffn as jmoe_ffn
from tpullm.ops.dequant import dequant_jax
from tpullm.ops.qtensor import QTensor as JQTensor
from tpullm.ops.qtensor import qtensor_from_float
from tpullm.quant.layout import decode_planar as jdecode_planar
from tpullm.quant.numpy_impl import quantize
from tpullm.runtime.engine import InferenceEngine as JEngine
from tpullm.runtime.loader import _stack_qtensors
from tpullm.runtime.loader import load_model as jload
from tpullm.server.context import GenParams as JGenParams
from tpullm.server.context import ServerContext as JServerContext
from tpullm.server.context import Task as JTask
from tpullm.utils.synth import build_arch_gguf, build_deepseek2_gguf
from tpullm_torch.models.config import ModelConfig
from tpullm_torch.models.llama import (KVCache, _moe_loop, _moe_prefill_ragged, chunk_bank,
                                       forward, moe_ffn)
from tpullm_torch.ops.dequant import PLANAR_PORTED, dequant_torch
from tpullm_torch.ops.moe_decode import moe_decode
from tpullm_torch.ops.qtensor import QTensor, qtensor_from_bytes
from tpullm_torch.quant.layout import decode_planar
from tpullm_torch.runtime.engine import InferenceEngine
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.server.context import GenParams, ServerContext, Task
from tpullm_torch.utils.from_jax import params_from_numpy

torch.set_num_threads(2)

PROMPTS = [[3, 9, 4, 17, 6], [5, 1, 2], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 2, 3, 4, 5,
                                         6, 7, 8, 9, 30]]
E, USED, D, NFF = 8, 2, 512, 256
ARCHS = ["dbrx", "grok", "arctic", "grovemoe"]


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

def _stack(rng, n, k, lead, qtype=GGMLType.Q4_K):
    """A 2-layer stack of (lead..., n, k) weights of qtype, as the JAX
    loader stacks them (K-major where the kernels take k, else planar)."""
    per = [qtensor_from_float((rng.standard_normal(lead + (n, k)) * 0.05).astype(np.float32),
                              qtype, device_put=False) for _ in range(2)]
    return _stack_qtensors(per, device_put=False)


@functools.lru_cache(maxsize=None)
def _layer(seed, n_chexp=0, down_qtype=GGMLType.Q8_0, router_scale=0.1):
    """(JAX qw, port qw) of a 2-layer stack of E experts (gate/up/down
    Q4_K), with a chunk bank of E // 2 chunk experts of n_chexp (gate/up
    Q4_K at K D, down of down_qtype at K n_chexp) where n_chexp > 0."""
    rng = np.random.default_rng(seed)
    router = (rng.standard_normal((2, E, D)) * router_scale).astype(np.float32)
    jqw = {"moe_gate_inp": qtensor_from_float(router, GGMLType.F32, device_put=False),
           "moe_gate_exps": _stack(rng, NFF, D, (E,)), "moe_up_exps": _stack(rng, NFF, D, (E,)),
           "moe_down_exps": _stack(rng, D, NFF, (E,))}
    if n_chexp:
        jqw["moe_gate_chexps"] = _stack(rng, n_chexp, D, (E // 2,))
        jqw["moe_up_chexps"] = _stack(rng, n_chexp, D, (E // 2,))
        jqw["moe_down_chexps"] = _stack(rng, D, n_chexp, (E // 2,), down_qtype)
    return jqw, {k: _port(v) for k, v in jqw.items()}


def _x(T, seed=0):
    return (np.random.default_rng(100 + seed + T).standard_normal((1, T, D)) * 0.5).astype(
        np.float32)


def _against_jax(jqw, qw, base, T, p=None):
    x = _x(T)
    want = np.asarray(jmoe_ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in (p or {}).items()},
                               jqw, jnp.int32(1), JConfig(**base), jnp.float32))
    got = moe_ffn(torch.from_numpy(x), qw, 1, ModelConfig(**base), torch.float32,
                  probs_b=None if p is None else torch.from_numpy(p["moe_probs_b"]))
    return got.numpy(), want


@pytest.mark.parametrize("T", [5, 24])
def test_gelu_experts_match_jax(T):
    """grok's GELU experts (tanh approximation on the gate, times up) in
    moe_ffn against the JAX moe_ffn at B*T <= 16 (the JAX decode's
    lax.cond) and above, NMSE < 1e-10 in f32; silu gives another result."""
    jqw, qw = _layer(1)
    base = dict(arch="grok", n_embd=D, n_expert=E, n_expert_used=USED, act_fn="gelu",
                expert_weights_norm=True)
    got, want = _against_jax(jqw, qw, base, T)
    assert _nmse(got, want) < 1e-10
    silu, _ = _against_jax(jqw, qw, dict(base, act_fn="silu"), T)
    assert _nmse(silu, want) > 1e-6


@pytest.mark.parametrize("T", [5, 24])
def test_grovemoe_sigmoid_selection_matches_jax(monkeypatch, T):
    """grovemoe picks its top-k by sigmoid(logits) and weights them by the
    softmax probabilities (llama.py:394-397), the selection bias unread
    there. With router logits large enough that sigmoid saturates to 1.0
    in f32 the picks are ties broken by index, which a softmax top-k (or
    the bias) would not pick: the port's picks and output equal the JAX
    package's (NMSE < 1e-10), and differ from the softmax selection's."""
    jqw, qw = _layer(2, n_chexp=128, router_scale=4.0)
    base = dict(arch="grovemoe", n_embd=D, n_expert=E, n_expert_used=USED,
                expert_weights_norm=True, n_group_experts=2, expert_group_scale=0.05)
    bias = {"moe_probs_b": np.linspace(1.0, 0.0, E).astype(np.float32)}
    picks, real = [], llama.top_k
    monkeypatch.setattr(llama, "top_k", lambda p, k: picks.append(real(p, k)) or picks[-1])
    got, want = _against_jax(jqw, qw, base, T, bias)
    assert _nmse(got, want) < 1e-10
    x = torch.from_numpy(_x(T))
    logits = x @ qw["moe_gate_inp"].data["w"][1].T
    by_softmax = real(torch.softmax(logits, -1), USED)
    assert (picks[0] != by_softmax).any()
    monkeypatch.setattr(llama, "top_k", real)
    plain = moe_ffn(x, qw, 1, ModelConfig(**dict(base, n_group_experts=0)), torch.float32)
    assert _nmse(plain.numpy(), want) > 1e-6


def _chunk_rows(T, seed=0):
    """The chunk ids a T-row grovemoe layer 1 routes (top-2 of 8 // 2)."""
    jqw, qw = _layer(3, n_chexp=128)
    x = torch.from_numpy(_x(T, seed))
    return llama.top_k(torch.sigmoid(x @ qw["moe_gate_inp"].data["w"][1].T), USED) // 2


@pytest.mark.parametrize("down", [GGMLType.Q8_0, GGMLType.Q5_0], ids=["q8_0", "q5_0"])
@pytest.mark.parametrize("T", [5, 24])
def test_chunk_bank_matches_jax(T, down):
    """The chunk bank (64 chunks in GroveMoE, here 4) with a planar chunk
    down at K 128 (Q8_0, and Q5_0, llama.cpp's fallback types for such rows),
    the gate and up K-major Q4_K at K 512, against the JAX moe_ffn, NMSE <
    1e-10; some row names one chunk twice (both its picks in one group), and
    the bank moves the output (without it, NMSE > 1e-8)."""
    jqw, qw = _layer(3, n_chexp=128, down_qtype=down)
    assert qw["moe_down_chexps"].layout == "planar" and qw["moe_gate_chexps"].layout == "kmajor"
    base = dict(arch="grovemoe", n_embd=D, n_expert=E, n_expert_used=USED,
                expert_weights_norm=True, n_group_experts=2, expert_group_scale=0.05)
    got, want = _against_jax(jqw, qw, base, T)
    assert _nmse(got, want) < 1e-10
    chunks = _chunk_rows(T)
    assert (chunks[..., 0] == chunks[..., 1]).any(), chunks
    no_bank = {k: v for k, v in qw.items() if "chexps" not in k}
    plain = moe_ffn(torch.from_numpy(_x(T)), no_bank, 1, ModelConfig(**base), torch.float32)
    assert _nmse(plain.numpy(), want) > 1e-8


@pytest.mark.parametrize("path", ["skip", "ragged"])
def test_chunk_bank_kernel_paths_sum_twice_named_chunks(path, monkeypatch):
    """The plain versions of the paths the chunk bank takes on the card, the
    skip's (decode, 5 rows) and kernel F's (prefill, 40 rows), on K-major
    Q8_0 chunk stacks at a chunk FFN of 256, against the loop over every
    chunk, with rows that name one chunk twice: the skip bit for bit; F,
    which takes its rows in bf16, within bf16's rounding of the loop (NMSE
    < 1e-4) and at NMSE < 1e-12 against itself on the same rows with each
    chunk's weights summed onto its first naming (a later one weighted 0),
    where a row that kept only one of the two weights is off by NMSE >
    1e-4."""
    jqw, qw = _layer(4, n_chexp=256, down_qtype=GGMLType.Q8_0)
    qw = dict(qw)
    rng = np.random.default_rng(9)
    for k in ("moe_gate_chexps", "moe_up_chexps"):
        qw[k] = _port(_stack(rng, 256, D, (E // 2,), GGMLType.Q8_0))
    assert all(qw[k].layout == "kmajor" for k in ("moe_gate_chexps", "moe_up_chexps",
                                                   "moe_down_chexps"))
    T = 5 if path == "skip" else 40
    cfg = ModelConfig(arch="grovemoe", n_embd=D, n_expert=E, n_expert_used=4,
                      expert_weights_norm=True, n_group_experts=2, expert_group_scale=0.05)
    x = torch.from_numpy(_x(T))
    top_i = torch.from_numpy(np.stack([np.random.default_rng(t).permutation(E)[:4]
                                       for t in range(T)]))[None]
    top_i[0, 0, :2] = torch.tensor([2, 3])  # chunk 1 twice
    probs = torch.softmax(torch.randn((1, T, E), generator=torch.Generator().manual_seed(1)), -1)
    chunk_i = top_i // 2
    assert (chunk_i[..., :, None] == chunk_i[..., None, :]).sum() > 4 * T
    w = torch.gather(probs, -1, chunk_i)
    w = w / w.sum(-1, keepdim=True)
    args = (qw["moe_gate_chexps"], qw["moe_up_chexps"], qw["moe_down_chexps"], 1)
    want = _moe_loop(x, w, chunk_i, *args, E // 2, torch.float32)
    if path == "skip":
        got = moe_decode(x, w, chunk_i, *args, E // 2, torch.float32)
        assert torch.equal(got, want)
    else:
        ragged = lambda wt: _moe_prefill_ragged(
            x, wt, chunk_i, *args, dataclasses.replace(cfg, n_expert=E // 2), torch.float32)
        got = ragged(w)
        assert _nmse(got.numpy(), want.numpy()) < 1e-4
        later = torch.triu(chunk_i[..., :, None] == chunk_i[..., None, :], 1)  # (.., j', j)
        merged = w + (later * w[..., None, :]).sum(-1)
        merged = merged * (~later.any(-2))
        assert _nmse(got.numpy(), ragged(merged).numpy()) < 1e-12
        one_only = w * (~later.any(-2))
        assert _nmse(ragged(one_only).numpy(), got.numpy()) > 1e-4
    # the bank itself routes by moe_route: the loop on the CPU
    routes = []
    real = llama.moe_route
    monkeypatch.setattr(llama, "moe_route", lambda *a, **k: routes.append(real(*a, **k))
                        or routes[-1])
    chunk_bank(x, probs, top_i, qw, 1, cfg, torch.float32)
    assert routes == ["loop"]


# ------------------------------------------------- K-major files, end to end

def _build(path, arch, n_layer=2):
    """``arch``'s synth file at n_embd 512 (4 experts of 512, top-2, Q4_K
    K-major; grok and arctic with their dense FFN, grovemoe with its chunk
    bank of 2 chunk experts of 512)."""
    build_arch_gguf(path, arch, n_embd=D, n_layer=n_layer, n_head=4, n_head_kv=2, n_ff=512,
                    qtype=GGMLType.Q4_K, seed=11)
    return path


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{arch: (path, JAX config, params, result of PROMPTS)}."""
    out = {}
    d = tmp_path_factory.mktemp("moe_families")
    for arch in ARCHS:
        path = _build(str(d / f"{arch}.gguf"), arch)
        jcfg, jparams, _ = jload(path)
        jr = JEngine(jcfg, jparams, max_seq_len=64, compute_dtype=jnp.float32,
                     decode_chunk=4).generate(PROMPTS, max_new_tokens=8, return_logits=True)
        out[arch] = (path, jcfg, jparams, jr)
    return out


def _generate(cfg, params, n=8):
    return InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                           decode_chunk=4, device="cpu").generate(
        PROMPTS, max_new_tokens=n, return_logits=True)


@pytest.mark.parametrize("via", ["loader", "params_from_numpy"])
@pytest.mark.parametrize("arch", ARCHS)
def test_kmajor_generate_matches_jax(models, arch, via):
    """First-step logits at NMSE < 1e-6 and identical greedy tokens against
    the JAX engine (both sides the plain f32 path), each row's tensors as
    the port lays them out: K-major experts, grok's and arctic's dense FFN
    beside them, grovemoe's K-major chunk bank; the config as the JAX
    parser's."""
    path, jcfg, jparams, jr = models[arch]
    if via == "loader":
        cfg, params, _ = load_model(path, device="cpu")
    else:
        cfg, params = params_from_numpy(dataclasses.asdict(jcfg), _flatten(jparams),
                                        device="cpu")
    fields = lambda c: {k: v for k, v in dataclasses.asdict(c).items() if k != "raw_kv"}
    assert fields(cfg) == fields(jcfg)
    lay = params["layers"]
    assert lay["moe_gate_exps"].layout == "kmajor"
    if arch in ("grok", "arctic"):
        assert {"ffn_gate", "ffn_up", "ffn_down"} <= set(lay) or "ffn_gateup" in lay
    if arch == "grovemoe":
        assert cfg.n_group_experts == 2 and cfg.expert_group_scale == pytest.approx(0.05)
        assert all(lay[k].layout == "kmajor" for k in ("moe_gate_chexps", "moe_down_chexps"))
    r = _generate(cfg, params)
    assert _nmse(r.logits, jr.logits) < 1e-6
    assert r.tokens == jr.tokens


def _strip(params, keys):
    return dict(params, layers={k: v for k, v in params["layers"].items() if k not in keys})


def test_grok_without_dense_ffn_matches_jax(models):
    """grok's block on layers without a dense FFN runs the MoE alone, not
    scaled by sqrt(2)/2 (llama.py:1295-1306): both packages' params with the
    dense FFN taken out give the same logits (NMSE < 1e-6) and tokens, and
    not those of the layers with it."""
    path, jcfg, jparams, jr = models["grok"]
    dense = {"ffn_gate", "ffn_up", "ffn_down", "ffn_gateup"}
    jfree = dict(jparams, layers={k: v for k, v in jparams["layers"].items() if k not in dense})
    jr0 = JEngine(jcfg, jfree, max_seq_len=64, compute_dtype=jnp.float32,
                  decode_chunk=4).generate(PROMPTS, max_new_tokens=4, return_logits=True)
    cfg, params, _ = load_model(path, device="cpu")
    r = _generate(cfg, _strip(params, dense), 4)
    assert _nmse(r.logits, jr0.logits) < 1e-6
    assert r.tokens == jr0.tokens
    assert _nmse(jr0.logits, jr.logits) > 1e-4


def test_arctic_moe_reads_the_layer_input(models, monkeypatch):
    """arctic's MoE reads the LAYER input under ffn_norm_exps, the dense FFN
    the FFN input under ffn_norm (llama.py:1307-1314): on each layer the
    norm with ffn_norm_exps takes the very tensor the attention norm took
    (x0), which differs from the FFN norm's input (ffn_inp = x0 + the
    attention's output) by NMSE > 1e-3, so the JAX match above tells the two
    apart."""
    path = models["arctic"][0]
    cfg, params, _ = load_model(path, device="cpu")
    lay = params["layers"]
    calls, real = [], llama._norm
    monkeypatch.setattr(llama, "_norm", lambda x, w, b, c: calls.append((x, w)) or real(x, w, b,
                                                                                         c))
    cache = KVCache.create(cfg, 1, 16, torch.float32, "cpu")
    tok = torch.tensor([PROMPTS[2][:12]])
    forward(params, cfg, tok, torch.arange(12)[None], cache, 0,
            torch.zeros(1, dtype=torch.int64), torch.float32)
    same = lambda w, key, li: w is not None and torch.equal(w, lay[key][li])
    for li in range(cfg.n_layer):
        x0 = next(x for x, w in calls if same(w, "attn_norm", li))
        ffn_inp = next(x for x, w in calls if same(w, "ffn_norm", li))
        exps = next(x for x, w in calls if same(w, "ffn_norm_exps", li))
        assert exps is x0
        assert _nmse(ffn_inp.numpy(), x0.numpy()) > 1e-3


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


@pytest.mark.parametrize("kv", ["q8", "f32"])
def test_grovemoe_server_context_matches_jax(models, kv):
    """Identical greedy tokens and prefix reuse from the port's and the JAX
    package's ServerContext on the grovemoe file (token ids, f32 compute, 2
    slots, decode chunks of 4, prefill chunks of 8)."""
    path, jcfg, jparams, _ = models["grovemoe"]
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


# ----------------------------------------------------- renames and refusals

def _snapshot_file(tmp_path, arch, extra=None):
    """``arch``'s snapshot file (build_arch_gguf seed 11) with ``extra``
    {name: f32 array} tensors."""
    write = GGUFWriter.write

    def write_extra(self):
        for name, arr in (extra or {}).items():
            self.add_tensor(name, arr)
        return write(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(GGUFWriter, "write", write_extra)
        return build_arch_gguf(str(tmp_path / f"{arch}.gguf"), arch, seed=11)


@pytest.mark.parametrize("arch,name,key", [("grok", "attn_output_norm", "post_attn_norm"),
                                           ("dbrx", "attn_output_norm", "ffn_norm")])
def test_output_norm_renames(tmp_path, arch, name, key):
    """grok's post-attention norm and dbrx's FFN norm ship as
    attn_output_norm and load as the JAX loader renames them
    (loader.py:401-409), as the same arrays; dbrx's bias, which its graph
    does not read, is dropped as there. The same name on another arch's
    file raises."""
    extra = {f"blk.{i}.attn_output_norm.bias": np.full(64, 0.5, np.float32)
             for i in range(2)} if arch == "dbrx" else None
    path = _snapshot_file(tmp_path, arch, extra)
    cfg, params, _ = load_model(path, device="cpu")
    jcfg, jparams, _ = jload(path)
    lay = params["layers"]
    assert key in lay and not any("out_norm" in k for k in lay)
    np.testing.assert_array_equal(lay[key].numpy(), np.asarray(jparams["layers"][key]))
    assert "ffn_norm_b" not in lay
    other = _snapshot_file(tmp_path, "mixtral",
                           {"blk.0.attn_output_norm.weight": np.ones(64, np.float32)})
    with pytest.raises(NotImplementedError, match="attn_output_norm"):
        load_model(other, device="cpu")


def test_grok_layer_output_norm_raises(tmp_path):
    """llama.cpp's grok files carry the post-FFN norm as layer_output_norm
    (LLM_TENSOR_LAYER_OUT_NORM); the JAX loader maps it to layer_out_norm,
    which no decoder graph reads, so the reference drops it (its synth
    writes post_ffw_norm instead). The port raises rather than drop it."""
    path = _snapshot_file(tmp_path, "grok", {"blk.0.layer_output_norm.weight":
                                             np.ones(64, np.float32)})
    with pytest.raises(NotImplementedError, match="layer_output_norm"):
        load_model(path, device="cpu")
    jcfg, jparams, _ = jload(path)
    assert any("layer_out_norm" in gl for gl in jparams["layers"]["__groups__"])


def _forward(cfg, params):
    cache = KVCache.create(cfg, 1, 16, torch.float32, "cpu")
    tok = torch.tensor([[3, 9, 4, 17, 6]])
    return forward(params, cfg, tok, torch.arange(5)[None], cache, 0,
                   torch.zeros(1, dtype=torch.int64), torch.float32)


@pytest.mark.parametrize("case", ["chunks_without_groups", "norm_exps_outside_arctic",
                                  "dense_ffn_on_moe_layer", "partial_chunk_bank",
                                  "chunk_count", "arctic_without_dense_ffn"])
def test_unread_tensor_refusals(tmp_path, case):
    """The tensors a config's graph would not read still raise in forward,
    each by name: the chunk bank without n_group_experts, ffn_norm_exps on
    a MoE layer that is not arctic's, a dense FFN on a MoE layer outside
    grok's and arctic's blocks, a chunk bank without all three stacks, a
    chunk stack of another count than n_expert // n_group_experts; and
    arctic's block without its dense FFN."""
    arch = {"chunks_without_groups": "grovemoe", "norm_exps_outside_arctic": "arctic",
            "dense_ffn_on_moe_layer": "grok", "partial_chunk_bank": "grovemoe",
            "chunk_count": "grovemoe", "arctic_without_dense_ffn": "arctic"}[case]
    cfg, params, _ = load_model(_snapshot_file(tmp_path, arch), device="cpu")
    assert torch.isfinite(_forward(cfg, params)[0]).all()
    lay = params["layers"]
    if case == "chunks_without_groups":
        cfg, match = dataclasses.replace(cfg, n_group_experts=0), "moe_gate_chexps"
    elif case == "norm_exps_outside_arctic":
        cfg, match = dataclasses.replace(cfg, moe_dense_parallel="grok"), "ffn_norm_exps"
    elif case == "dense_ffn_on_moe_layer":
        cfg, match = dataclasses.replace(cfg, moe_dense_parallel=""), "ffn_"
    elif case == "partial_chunk_bank":
        params, match = _strip(params, {"moe_up_chexps"}), "chunk-expert bank"
    elif case == "chunk_count":
        g = lay["moe_gate_chexps"]
        cut = lambda t: QTensor(t.qtype, t.shape[:1] + (1,) + t.shape[2:],
                                {k: v[:, :1] for k, v in t.data.items()})
        params = dict(params, layers=dict(lay, **{k: cut(lay[k]) for k in lay if "chexps" in k}))
        match = f"{g.shape[1]}|chunk experts"
    else:
        params, match = _strip(params, {"ffn_gate", "ffn_up", "ffn_down", "ffn_gateup"}), "FFN"
    with pytest.raises(NotImplementedError, match=match):
        _forward(cfg, params)


def test_grove_keys_read_for_grovemoe_only():
    """experts_per_group, expert_group_scale and
    expert_chunk_feed_forward_length parse on a grovemoe file as the JAX
    parser reads them, and raise on another arch's (whose top-k the JAX
    graph would switch to sigmoid selection, where llama.cpp reads the keys
    in grovemoe's graph alone)."""
    from tpullm_torch.models.config import config_from_gguf

    class Meta:
        def __init__(self, arch, md):
            self.architecture = arch
            self.metadata = {"general.architecture": arch, **md}

        def get(self, k, default=None):
            return self.metadata.get(k, default)

    md = lambda a: {f"{a}.experts_per_group": 2, f"{a}.expert_group_scale": 0.05,
                    f"{a}.expert_chunk_feed_forward_length": 128, f"{a}.expert_count": 128,
                    f"{a}.expert_used_count": 8}
    cfg = config_from_gguf(Meta("grovemoe", md("grovemoe")))
    assert (cfg.n_group_experts, cfg.n_ff_chexp) == (2, 128)
    assert cfg.expert_group_scale == pytest.approx(0.05)
    with pytest.raises(NotImplementedError, match="experts_per_group"):
        config_from_gguf(Meta("qwen3moe", md("qwen3moe")))


# ------------------------------------------------------------ planar Q5_0

@pytest.mark.parametrize("K", [128, 1408, 10944])
def test_planar_q5_0_bit_exact(K):
    """Planar Q5_0 (qs, qh and d) dequantizes to the f32 bits of the JAX
    dequant_jax at K 128 (GroveMoE's chunk down), 1408 and 10944
    (DeepSeek-V2-Lite's expert and dense down in a Q4_K_M file); a weight of
    it loads planar and its product runs."""
    assert GGMLType.Q5_0 in PLANAR_PORTED
    rng = np.random.default_rng(K)
    x = (rng.standard_normal((4, K)) * np.exp(rng.standard_normal((4, 1)))).astype(np.float32)
    raw = quantize(x, GGMLType.Q5_0)
    want = np.asarray(dequant_jax(jdecode_planar(raw.reshape(4, -1), GGMLType.Q5_0),
                                  GGMLType.Q5_0))
    planar = {k: torch.from_numpy(np.asarray(v))
              for k, v in decode_planar(raw.reshape(4, -1), GGMLType.Q5_0).items()}
    got = dequant_torch(planar, GGMLType.Q5_0).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    qt = qtensor_from_bytes(raw.reshape(-1), GGMLType.Q5_0, (4, K))
    if K == 128:
        assert qt.layout == "planar"
    assert torch.equal(qt.dequant(torch.float32), torch.from_numpy(got))


def test_q4_k_m_deepseek_with_q5_0_rows_loads(tmp_path, monkeypatch):
    """A DeepSeek-V2-shaped MLA MoE file as a Q4_K_M quantization lays it
    out (Q4_K where K is a multiple of 256, else Q5_0, llama.cpp's fallback)
    loads in the port, its Q5_0 rows planar, and matches the JAX engine:
    first-step logits NMSE < 1e-6, identical greedy tokens."""
    real = jsynth._add_quant_tensor

    def q4_k_m(w, name, arr, qtype):
        if qtype != GGMLType.F32:
            qtype = GGMLType.Q4_K if arr.shape[-1] % 256 == 0 else GGMLType.Q5_0
        return real(w, name, arr, qtype)

    monkeypatch.setattr(jsynth, "_add_quant_tensor", q4_k_m)
    path = build_deepseek2_gguf(str(tmp_path / "ds.gguf"), n_embd=256, moe=True,
                                split_mla=True, n_ff=512, n_ff_exp=192, seed=5)
    cfg, params, _ = load_model(path, device="cpu")
    qts = [v for gl in params["layers"]["__groups__"] for v in gl.values()
           if isinstance(v, QTensor)]
    assert any(q.qtype == GGMLType.Q5_0 and q.layout == "planar" for q in qts)
    jcfg, jparams, _ = jload(path)
    jr = JEngine(jcfg, jparams, max_seq_len=64, compute_dtype=jnp.float32,
                 decode_chunk=4).generate(PROMPTS, max_new_tokens=6, return_logits=True)
    r = _generate(cfg, params, 6)
    assert _nmse(r.logits, jr.logits) < 1e-6
    assert r.tokens == jr.tokens
