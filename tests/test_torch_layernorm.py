"""The layernorm, bias and parallel-residual decoders in the port held
against the JAX package on the CPU: layernorm with and without weight and
bias (olmo's weightless one), the output projection's bias, the ungated
GELU and relu2 FFNs with their biases, olmo's clamp of q, k and v, and the
parallel block off the attention's norm (phi2, command-r, falcon-7B),
``ffn_norm`` (gptneox) or ``attn_norm_2`` (falcon-40B). Each of the 15
registry rows goes through its arch snapshot; command-r, starcoder2, phi2,
falcon and nemotron at Q4_K K-major widths through both packages (the
port's loader and the params carried across); a port ServerContext against
a JAX one for command-r (int8 KV) and cohere2 (f32 KV on the iSWA ring,
prompts past the window); each arch's layer-kernel decision against the
JAX gate; the synth's new draws; and each place where the JAX package
departs from llama.cpp, pinned as the JAX package computes it.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_layernorm.py -q
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGMLType
from tpullm.gguf.writer import GGUFWriter
from tpullm.models.llama import layer_norm as jlayer_norm
from tpullm.ops.layer_kernel import supported as jblock_supported
from tpullm.ops.qtensor import QTensor as JQTensor
from tpullm.runtime.engine import InferenceEngine as JEngine
from tpullm.runtime.loader import load_model as jload
from tpullm.server.context import GenParams as JGenParams
from tpullm.server.context import ServerContext as JServerContext
from tpullm.server.context import Task as JTask
from tpullm.utils.synth import build_arch_gguf
from tpullm_torch.models.llama import (KVCache, forward, layer_norm, layer_routes,
                                       swa_flags)
from tpullm_torch.ops.qtensor import QTensor
from tpullm_torch.runtime.engine import InferenceEngine
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.server.context import GenParams, ServerContext, Task
from tpullm_torch.utils.from_jax import params_from_numpy

torch.set_num_threads(2)

SNAP_DIR = os.path.join(os.path.dirname(__file__), "snapshots")
# the rows this slice added: layernorm (with biases, weightless), the
# ungated FFNs, relu2, the clamp and the parallel block
LAYERNORM_ARCHS = ["stablelm", "orion", "cohere2", "olmo", "starcoder2", "codeshell",
                   "nemotron", "jais2", "arcee", "phi2", "command-r", "gptneox", "falcon",
                   "gptj", "plamo"]
KMAJOR_ARCHS = ["command-r", "starcoder2", "phi2", "falcon", "nemotron"]
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


@pytest.mark.parametrize("arch", LAYERNORM_ARCHS)
def test_arch_snapshot(arch, tmp_path):
    """tests/snapshots/{arch}.npz (the JAX package's golden, from
    build_arch_gguf(seed=11): Q8_0 at n_embd 64, so planar weights) through
    the port's loader and engine on the CPU in f32, with the bar of
    tests/test_arch_snapshots.py:69-73."""
    path = str(tmp_path / f"{arch}.gguf")
    build_arch_gguf(path, arch, seed=11)
    cfg, params, _ = load_model(path, device="cpu")
    assert cfg.arch == arch
    eng = InferenceEngine(cfg, params, max_seq_len=64, compute_dtype=torch.float32,
                          decode_chunk=4, device="cpu")
    r = eng.generate([[3, 9, 4, 17, 6]], max_new_tokens=8, return_logits=True)
    snap = np.load(os.path.join(SNAP_DIR, f"{arch}.npz"))
    nmse = _nmse(np.asarray(r.logits[0], np.float32), snap["logits"])
    assert nmse < 1e-6, (arch, nmse)
    assert (np.asarray(r.tokens[0]) == snap["tokens"]).mean() >= 0.75


@pytest.mark.parametrize("weight,bias", [(True, True), (True, False), (False, False)])
def test_layer_norm_matches_jax(weight, bias):
    """layer_norm against the JAX function, f32 and bf16 inputs: with weight
    and bias, weight only, and weightless (olmo)."""
    rng = np.random.default_rng(5)
    x = rng.normal(0.5, 2.0, (3, 7, 96)).astype(np.float32)
    w = (1 + rng.normal(0, 0.1, 96)).astype(np.float32) if weight else None
    b = rng.normal(0, 0.1, 96).astype(np.float32) if bias else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    j = lambda a: None if a is None else jnp.asarray(a)
    got = layer_norm(torch.from_numpy(x), t(w), t(b), 1e-5)
    want = np.asarray(jlayer_norm(jnp.asarray(x), j(w), j(b), 1e-5))
    assert _nmse(got, want) < 1e-12
    got16 = layer_norm(torch.from_numpy(x).to(torch.bfloat16), t(w), t(b), 1e-5)
    want16 = jlayer_norm(jnp.asarray(x, jnp.bfloat16), j(w), j(b), 1e-5)
    assert got16.dtype == torch.bfloat16
    assert _nmse(got16.float(), np.asarray(want16.astype(jnp.float32))) < 1e-5


@pytest.fixture(scope="module")
def kmajor_models(tmp_path_factory):
    """{arch: (path, JAX cfg, JAX params, JAX result of PROMPTS)}: each arch
    at K-major widths, Q4_K, generated once by the JAX engine."""
    out = {}
    d = tmp_path_factory.mktemp("layernorm")
    for arch in KMAJOR_ARCHS + ["cohere2"]:
        path = str(d / f"{arch}.gguf")
        build_arch_gguf(path, arch, **KMAJOR)
        jcfg, jparams, _ = jload(path)
        jr = None
        if arch in KMAJOR_ARCHS:
            jr = JEngine(jcfg, jparams, max_seq_len=64, compute_dtype=jnp.float32,
                         decode_chunk=4).generate(PROMPTS, max_new_tokens=8,
                                                  return_logits=True)
        out[arch] = (path, jcfg, jparams, jr)
    return out


@pytest.mark.parametrize("via", ["loader", "params_from_numpy"])
@pytest.mark.parametrize("arch", KMAJOR_ARCHS)
def test_kmajor_generate_matches_jax(kmajor_models, arch, via):
    """First-step logits at NMSE < 1e-6 and identical greedy tokens (both
    sides run the plain f32 path), the weights K-major as the kernels take
    them, every layernorm bias, bo, FFN bias and attn_norm_2 of the file
    carried across."""
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
    assert ("output_norm_b" in params) == ("output_norm_b" in jparams)
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


@pytest.mark.parametrize("arch,kv,iswa", [("command-r", "q8", False),
                                          ("cohere2", "f32", True)])
def test_server_context_matches_jax(kmajor_models, arch, kv, iswa):
    """Identical greedy tokens and prefix reuse from the port's and the JAX
    package's ServerContext (token ids, f32 compute, 2 slots, decode chunks
    of 4, prefill chunks of 32): command-r on the int8 cache; cohere2 (3 of
    4 layers SWA, window 32) on the iSWA ring of 64 slots with prompts of
    70 and 45 tokens, past the window."""
    path, jcfg, jparams, _ = kmajor_models[arch]
    cfg, params, _ = load_model(path, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 250, n).tolist() for n in (70, 45, 12)]
    common = dict(n_slots=2, max_seq_len=256, decode_chunk=4, prefill_chunk=32, iswa=iswa)
    jctx = JServerContext(jcfg, jparams, None, compute_dtype=jnp.float32,
                          kv_dtype={"f32": jnp.float32, "q8": "q8"}[kv], **common)
    tctx = ServerContext(cfg, params, None, compute_dtype=torch.float32,
                         kv_dtype={"f32": torch.float32, "q8": "q8"}[kv], device="cpu",
                         **common)
    assert tctx.memory.cache.dual == iswa == any(swa_flags(cfg))
    want = _serve(jctx, JTask, JGenParams, prompts)
    got = _serve(tctx, Task, GenParams, prompts)
    assert got == want
    assert all(len(toks) == 8 for toks, _ in got)


# --------------------------------------------------------------------- gates

# (use_block, use_fold) of a decode step (B = 4, T = 1) on the card: every
# new row stays off the layer kernel (layernorm, the parallel block, the
# ungated FFN, the biases close it), as do the MoE rows; the other rows of
# the registry that tests/test_torch_arch_flags.py's table leaves out take
# it, folded
GATES = dict({a: (False, False) for a in LAYERNORM_ARCHS},
             **{a: (False, False) for a in ("mixtral", "qwen3moe", "qwen2moe", "granitemoe")},
             **{a: (True, True) for a in ("llama", "mistral3", "internlm2", "exaone",
                                          "baichuan", "xverse", "ernie4_5")})


@pytest.mark.parametrize("arch", sorted(GATES))
def test_layer_routes_match_jax_gate(arch, tmp_path):
    """The port's decode-block and fold choices (layer_routes) equal the
    table above and the JAX package's conditions (llama.py:1382-1423, the
    TPU backend taken as present), evaluated on the JAX package's own
    params of the same GGUF; a prefill (T = 512) and the CPU take neither.
    With tests/test_torch_arch_flags.py's table and
    tests/test_torch_moe_bias.py's rows this covers every row of the port's
    registry."""
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


def test_gate_closes_on_each_bias(tmp_path):
    """On a llama layer that takes the layer kernel, each of the JAX gate's
    tensors alone (ffn_norm_b, bo, ffn_up_b, ffn_down_b, ffn_gate_b,
    attn_norm_2) closes it."""
    path = str(tmp_path / "llama.gguf")
    build_arch_gguf(path, "llama", **KMAJOR)
    cfg, params, _ = load_model(path, device="cpu")
    gl = params["layers"]
    qw = {k: v for k, v in gl.items() if isinstance(v, QTensor)}
    assert layer_routes(cfg, gl, qw, 4, 1, True, 1) == (True, True)
    for k in ("ffn_norm_b", "bo", "ffn_up_b", "ffn_down_b", "ffn_gate_b", "attn_norm_2"):
        assert layer_routes(cfg, dict(gl, **{k: gl["ffn_norm"]}), qw, 4, 1, True, 1) == (
            False, False), k


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
    ("llama", "blk.0.attn_norm.bias", 64, "attn_norm_b"),
    ("llama", "output_norm.bias", 64, "output_norm_b"),
    ("starcoder2", "blk.0.attn_norm_2.weight", 64, "attn_norm_2"),
    ("qwen3moe", "blk.0.ffn_down.bias", 64, "ffn_down_b"),
    ("phi2", "blk.0.ffn_gate.weight", None, "ffn_gate")])
def test_unread_tensor_raises(tmp_path, monkeypatch, arch, name, n, what):
    """A tensor the config's graph does not read raises in forward (the JAX
    package would ignore it): a norm bias without layernorm (a layer's and
    the output norm's), attn_norm_2 without the parallel block, an FFN bias
    on a MoE layer, a gate weight on an ungated FFN."""
    arr = np.ones(n, np.float32) if n else np.zeros((96, 64), np.float32)
    path = _with_tensors(tmp_path, monkeypatch, arch, {name: arr})
    cfg, params, _ = load_model(path, device="cpu")
    with pytest.raises(NotImplementedError, match=what):
        _forward(cfg, params)


def test_phi2_output_bias_raises(tmp_path, monkeypatch):
    """phi-2's files carry output.bias (the lm_head's bias), which the JAX
    loader drops: the port's loader raises on it rather than drop a weight
    (ROADMAP §3, known weak spots)."""
    path = _with_tensors(tmp_path, monkeypatch, "phi2", {"output.bias": np.ones(256, np.float32)})
    with pytest.raises(NotImplementedError, match="output.bias"):
        load_model(path, device="cpu")
    jcfg, jparams, _ = jload(path)
    assert not any("output_b" in k for k in jparams)


@pytest.mark.parametrize("arch,biases", [("command-r", False), ("starcoder2", True),
                                         ("falcon", False), ("nemotron", True)])
def test_synth_layernorm_rows(arch, biases):
    """synth_kmajor_q4k_fast with a layernorm row: layernorm weights (and
    where the row has attn_bias, ``biases`` here, their biases, bo and the
    FFN's), the ungated FFN's up
    weight where the row has no gate, no ffn_norm in a parallel block; the
    llama draws before them unchanged; a forward on the CPU that is finite
    and that the biases change."""
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    kw = dict(vocab_size=300, n_embd=256, n_layer=2, n_head=2, n_head_kv=2, n_ff=512,
              seed=3, centred=True, device="cpu")
    cfg, params = synth_kmajor_q4k_fast(arch=arch, exact_vocab=True,
                                        cfg_fields=dict(norm_eps=1e-5), **kw)
    _, base = synth_kmajor_q4k_fast(**kw)
    assert cfg.norm_type == "layernorm" and cfg.norm_eps == 1e-5 and cfg.attn_bias == biases
    layers = params["layers"]
    assert ("ffn_norm" in layers) == (not cfg.parallel_residual)
    assert ("ffn_up" in layers) == (not cfg.ffn_gate) == ("ffn_gateup" not in layers)
    bias_keys = {"bo", "ffn_up_b", "ffn_down_b", "attn_norm_b"} | (
        set() if cfg.parallel_residual else {"ffn_norm_b"})
    assert bias_keys & set(layers) == (bias_keys if biases else set())
    assert ("output_norm_b" in params) == biases
    for k in ("wqkv", "wo"):
        assert all(torch.equal(a, layers[k].data[n]) for n, a in base["layers"][k].data.items())
    assert not torch.equal(layers["attn_norm"], base["layers"]["attn_norm"])
    lg = _forward(cfg, params)
    assert lg.shape == (1, 5, 300) and torch.isfinite(lg).all()
    if biases:
        bare = dict({k: v for k, v in params.items() if k != "output_norm_b"},
                    layers={k: v for k, v in layers.items() if k not in bias_keys})
        assert _nmse(_forward(cfg, bare), lg) > 1e-4


def test_synth_generator_draws_the_same_layout():
    """synth_kmajor_q4k_fast with a torch.Generator draws every Q4_K weight
    with random_kmajor (the card's Command-R 35B takes seconds so): the
    same tensors, shapes and dtypes as the numpy draw, other values, a
    finite forward."""
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    kw = dict(arch="command-r", vocab_size=300, n_embd=256, n_layer=2, n_head=2, n_head_kv=2,
              n_ff=512, seed=3, centred=True, device="cpu", exact_vocab=True, tied=True,
              cfg_fields=dict(norm_eps=1e-5, logit_scale=0.0625))
    cfg, host = synth_kmajor_q4k_fast(**kw)
    _, dev = synth_kmajor_q4k_fast(**kw, generator=torch.Generator().manual_seed(0))
    assert set(dev) == set(host) and set(dev["layers"]) == set(host["layers"])
    assert dev["output"] is dev["tok_embd"]
    for k, v in host["layers"].items():
        if isinstance(v, QTensor):
            w = dev["layers"][k]
            assert w.shape == v.shape and set(w.data) == set(v.data), k
            assert all(w.data[n].shape == a.shape and w.data[n].dtype == a.dtype
                       for n, a in v.data.items()), k
            assert not torch.equal(w.data["q"], v.data["q"]), k
        else:
            assert dev["layers"][k].shape == v.shape, k
    lg = _forward(cfg, dev)
    assert lg.shape == (1, 5, 300) and torch.isfinite(lg).all()


# -------------------------------------------------- departures from llama.cpp

def test_cohere2_runs_sequential_with_ffn_norm(tmp_path):
    """The JAX cohere2 row has no parallel_residual and its synth writes an
    ffn_norm, so the FFN reads the normed stream after attention's residual
    (the sequential block); llama.cpp's cohere2 graph appears to run the FFN
    in parallel off the attention norm, as command-r does (ROADMAP §3). The
    port follows the JAX package: held against its first-step logits, and a
    parallel block (ffn_norm dropped) gives other logits."""
    path = str(tmp_path / "cohere2.gguf")
    build_arch_gguf(path, "cohere2", seed=11)
    cfg, params, _ = load_model(path, device="cpu")
    jcfg, jparams, _ = jload(path)
    assert not cfg.parallel_residual and "ffn_norm" in params["layers"]
    prompt = [3, 9, 4, 17, 6]
    got = _forward(cfg, params, prompt)[:, -1]
    jr = JEngine(jcfg, jparams, max_seq_len=64, compute_dtype=jnp.float32,
                 decode_chunk=4).generate([prompt], max_new_tokens=1, return_logits=True)
    assert _nmse(got, np.asarray(jr.logits)) < 1e-6
    par = dict(params, layers={k: v for k, v in params["layers"].items()
                               if k not in ("ffn_norm", "ffn_norm_b")})
    other = _forward(dataclasses.replace(cfg, parallel_residual=True), par, prompt)[:, -1]
    assert _nmse(other, got) > 1e-4


def test_clamp_kqv_after_rope(tmp_path):
    """olmo's clamp_kqv clamps q, k and v after RoPE (llama.py:889-892), as
    the JAX package does; llama.cpp's olmo graph appears to clamp the
    projections before RoPE (ROADMAP §3). At a clamp of 0.05 (the synth's
    8 does not bite at these widths) the port's first-step logits equal the
    JAX engine's and differ from the unclamped ones."""
    path = str(tmp_path / "olmo.gguf")
    build_arch_gguf(path, "olmo", seed=11)
    cfg, params, _ = load_model(path, device="cpu")
    jcfg, jparams, _ = jload(path)
    assert cfg.clamp_kqv == jcfg.clamp_kqv == 8.0
    assert "output_norm" not in params and "attn_norm" not in params["layers"]
    cfg, jcfg = (dataclasses.replace(c, clamp_kqv=0.05) for c in (cfg, jcfg))
    prompt = [3, 9, 4, 17, 6]
    got = _forward(cfg, params, prompt)[:, -1]
    jr = JEngine(jcfg, jparams, max_seq_len=64, compute_dtype=jnp.float32,
                 decode_chunk=4).generate([prompt], max_new_tokens=1, return_logits=True)
    assert _nmse(got, np.asarray(jr.logits)) < 1e-6
    loose = _forward(dataclasses.replace(cfg, clamp_kqv=0.0), params, prompt)[:, -1]
    assert _nmse(loose, got) > 1e-6

