"""Synthetic Llama params at the kernel layout (no GGUF, no network).

- ``synth_kmajor_q4k_fast``: counterpart of
  tpullm/utils/synth.py:synth_kmajor_q4k_fast (bench.py's weights), drawn
  from a numpy seed in the same order as the JAX package's, so both
  packages build identical weights from one seed; with ``centred=True`` the
  weights have mean ~0, like trained ones (the runs on the card);
- ``synth_moe_q4k``: the same attention, norms and embeddings with a
  routed-expert FFN in place of the dense one (F32 router, unfused Q4_K
  gate/up experts and Q4_K or Q6_K down experts stacked to (L, E, Npad, K),
  an optional Q4_K shared expert with or without its F32 sigmoid gate
  vector, optional leading dense layers and a router selection bias), the
  experts drawn on the device so no host array holds them, for any MoE arch
  of the registry (mixtral, qwen3moe, qwen2moe, ernie4_5-moe, ...);
  ``synth_mixtral_q4k`` is its Mixtral form;
- ``synth_mla_q4k``: an MLA model of the deepseek2 family (a direct or
  low-rank q, the compressed kv projection, the split absorption banks in
  f32, optional YaRN, a dense lead, routed experts and a shared expert),
  each weight Q4_K or, where K is not a multiple of 256, Q8_0, K-major
  or planar as the loader would lay it out, drawn on the device;
- ``synth_gptoss``: a gpt-oss model (MXFP4 experts with their biases and
  the router's bias, Q8_0 attention with q/k/v and output biases and
  per-head sinks, K-major or planar as the loader would lay each weight
  out), drawn on the device;
- ``synth_gemma3n``: a gemma3n model (AltUp and LAuReL in f32, the per-layer
  token table and its projections, owning and shared-KV layer groups, Q4_K
  K-major or planar as the loader would lay each weight out), drawn on the
  device with a torch.Generator;
- ``synth_dense_single``: a chameleon or bitnet model (chameleon's per-head
  layernorm q/k norms with their biases; bitnet's sub-norms and per-tensor
  scales over planar TQ2_0), K-major or planar as the loader would lay each
  weight out, drawn on the device with a torch.Generator;
- ``random_kmajor``: one weight of any K-major type, drawn on the device
  with a torch.Generator and centred the same way, for the kernel checks;
- ``synth_bpe_vocab``: a byte-level BPE vocab at Llama-3's or Qwen2's
  layout (merges drawn from a seed, the family's special tokens and chat
  template), for the server's text and chat paths.
Every array has the dtype, shape and value range pack_kmajor +
fuse_layer_weights would produce.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..models.config import ModelConfig, xielu_params
from ..models.registry import apply_arch_defaults
from ..ops._cuda import resolve_device
from ..ops.fuse import fuse_layer_weights, pad256
from ..ops.qtensor import QTensor
from ..quant.kmajor import KM_SPECS, dstore_for
from ..tokenizer.tokenizer import _BYTE_ENC
from ..tokenizer.vocab import TokenAttr, Vocab


def synth_kmajor_q4k_fast(*, vocab_size: int, n_embd: int, n_layer: int,
                          n_head: int, n_head_kv: int, n_ff: int, seed: int = 0,
                          centred: bool = False, device="cuda", dense_ffn: bool = True,
                          arch: str = "llama", rope_base: float = 10000.0,
                          rms_eps: float = 1e-5,
                          exact_vocab: bool = False, head_dim: int | None = None,
                          tied: bool = False, cfg_fields: dict | None = None,
                          generator: torch.Generator | None = None, n_ctx: int = 0,
                          tok_norm: bool = False, gguf_layout: bool = False):
    """-> (ModelConfig, params) with every tensor on ``device``. Each weight
    is drawn on the host, moved to the device and released before the next,
    so host memory holds one weight at a time.

    ``arch`` takes the registry row's defaults (the RoPE type among them);
    where the row sets ``attn_qk_norm`` the layers carry per-head
    ``q_norm``/``k_norm`` weights (1 + N(0, 0.1)), and where it sets
    ``attn_bias`` the biases ``bq``/``bk``/``bv`` (N(0, 0.5)), all f32 and
    drawn after every other array, so the other draws do not move.
    ``exact_vocab=True`` gives the embedding and lm_head their logical row
    count (vocab_size) over the 256-padded arrays, as the loader's have, so
    the logits are vocab_size wide; by default they have the padded count,
    as the JAX package's synth gives them. ``head_dim`` defaults to
    n_embd // n_head; another value gives q n_head * head_dim wide over the
    n_embd-wide stream (Qwen3-30B-A3B: 32 heads of 128 over 2048).
    Where the row sets ``post_norms`` (gemma2, gemma3) the layers also carry
    ``post_attn_norm``/``post_ffn_norm`` (1 + N(0, 0.1)), drawn after the q/k
    norms. ``tied=True`` makes the lm_head the embedding (one draw, as a
    GGUF without output.weight loads: cfg.tie_embeddings). ``cfg_fields``
    sets config fields as a file's keys would, before the row's defaults
    apply (a window, its pattern, softcaps, rope_base_swa, rope scaling,
    norm_eps).

    The layernorm, bias and parallel-residual rows: where the row sets
    ``ffn_gate=False`` the FFN's up weight (n_ff wide) is drawn where the
    fused gate/up would be; where it sets ``parallel_residual`` the layers
    carry no ffn_norm (the FFN reads the attention's normed input: phi2,
    command-r); where it sets layernorm the norm weights are 1 + N(0, 0.1)
    (attn_norm, ffn_norm, then output_norm), drawn after every array above.
    A layernorm row that sets ``attn_bias`` (starcoder2, nemotron, phi2:
    biases everywhere) then draws, in this order, the layernorm biases
    (attn_norm_b, ffn_norm_b, output_norm_b), the output projection's
    ``bo`` and the FFN's ``ffn_up_b`` and ``ffn_down_b``, all N(0, 0.1).
    The RMS-norm rows with ``attn_bias`` (the Qwen2 family) carry only
    bq/bk/bv, as their files do.

    ``centred=False`` draws the JAX package's weights. Their sub-mins are
    independent of the scales, so every weight row has a mean far from 0
    and the activations drift into one direction through depth.
    ``centred=True`` draws Q4_K the way random_kmajor does: sub-scales in
    [1, 8), sub-mins round(7.5 * s8) and dmin = d, so each group's grid is
    centred on 0, with d putting the weights' std near 1/sqrt(4096).
    ``dense_ffn=False`` leaves out the FFN weights (synth_mixtral_q4k's
    experts take their place); the other draws do not move.

    The rows without RoPE: ``n_ctx`` > 0 gives the model a learned f32
    position table ``pos_embd`` of n_ctx rows (N(0, 0.02): gpt2,
    starcoder), and ``tok_norm`` a layernorm on the embedding (``tok_norm``
    1 + N(0, 0.1), with its bias ``tok_norm_b`` N(0, 0.1) where the row sets
    attn_bias: bloom), drawn in that order after every array above. ALiBi
    comes through ``cfg_fields`` (alibi_max_bias, or refact's row), which
    turns RoPE off as config_from_gguf does; a single kv head (MQA) is
    ``n_head_kv=1``.

    ``generator`` (a torch.Generator on ``device``) draws every Q4_K
    weight there with random_kmajor, the centred recipe, so no host array
    holds it: a 35B model's 21.9 GB take seconds there, against ~45 s from
    numpy. The norms and biases still come from ``seed``'s numpy stream.

    ``gguf_layout=True`` lays out the attention and the gated FFN as a
    phi3 file holds them: the fused attn_qkv as ``wqkv_cat`` (one padded
    range of n_head + 2 n_head_kv heads) and the combined [gate; up] as one
    ``ffn_up`` of 2 x n_ff rows, drawn where wqkv and ffn_gateup would be
    (the same draws where every part is a multiple of 256 wide), then
    passed through the loader's fuse step (ops/fuse.py:fuse_layer_weights),
    which renames the combined ffn_up ffn_gateup where n_ff is a multiple
    of 256.

    A row with apertus's xIELU (act_fn xielu) gets the per-layer parameters
    that the JAX synth writes into its files (alpha_n 0.8 + 0.02 li, alpha_p
    0.8 - 0.01 li, beta 0.5, eps -1e-6; tpullm/utils/synth.py:2249-2253),
    folded as config_from_gguf folds them; no array is drawn for them."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    head_dim = head_dim or n_embd // n_head
    spec = KM_SPECS[GGMLType.Q4_K]

    def planes(lead, npad, K):
        ds = dstore_for(spec, K)
        shp = lambda rows: lead + (rows, npad)
        if centred:
            q = rng.integers(0, 256, shp(K // 2), dtype=np.uint8)
            d = (rng.random(shp(K // ds), np.float32) + 0.5) * 1e-3
            s8 = rng.integers(1, 8, shp(K // spec.gs), dtype=np.int8)
            out = {"q": q, "d": d, "s8": s8,
                   "m8": np.round(s8 * np.float32(7.5)).astype(np.int8), "dmin": d.copy()}
            return {k: torch.from_numpy(v).to(device) for k, v in out.items()}
        d = (rng.random(shp(K // ds), np.float32) + 0.5) * 2e-4
        dmin = (rng.random(shp(K // ds), np.float32) + 0.5) * 2e-4
        out = {
            "q": rng.integers(0, 256, shp(K // 2), dtype=np.uint8),
            "d": d.astype(np.float32),
            "s8": rng.integers(1, 64, shp(K // spec.gs)).astype(np.int8),
            "m8": rng.integers(0, 64, shp(K // spec.gs)).astype(np.int8),
            "dmin": dmin.astype(np.float32),
        }
        return {k: torch.from_numpy(v).to(device) for k, v in out.items()}

    def qt(parts, K, lead=(), n_out=None):
        npad = sum(pad256(p) for p in parts)
        data = (planes(lead, npad, K) if generator is None else
                random_kmajor(GGMLType.Q4_K, parts, K, lead, generator, device).data)
        return QTensor(GGMLType.Q4_K, lead + (n_out or npad, K), data)

    L = (n_layer,)
    nq, nkv = n_head * head_dim, n_head_kv * head_dim
    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=device)
    cfg = ModelConfig(
        arch=arch, vocab_size=vocab_size, n_embd=n_embd, n_layer=n_layer,
        n_head=n_head, n_head_kv=n_head_kv, head_dim=head_dim,
        head_dim_v=head_dim, n_ff=n_ff, rope_dim=head_dim, rope_base=rope_base,
        rms_eps=rms_eps, tie_embeddings=tied, **(cfg_fields or {}),
    )
    apply_arch_defaults(cfg)
    if cfg.alibi_max_bias > 0:  # as config_from_gguf: ALiBi replaces RoPE
        cfg.use_rope = False
    if cfg.act_fn == "xielu" and not cfg.xielu:
        cfg.xielu = jax_synth_xielu(n_layer)
    embd = qt([vocab_size], n_embd, n_out=exact_vocab and vocab_size)
    params = {
        "tok_embd": embd,
        "output": embd if tied else qt([vocab_size], n_embd, n_out=exact_vocab and vocab_size),
        "output_norm": ones(n_embd),
        "layers": {
            "attn_norm": ones(n_layer, n_embd),
            "ffn_norm": ones(n_layer, n_embd),
            "wqkv": (qt([nq + 2 * nkv], n_embd, L, n_out=nq + 2 * nkv) if gguf_layout
                     else qt([nq, nkv, nkv], n_embd, L)),
            "wo": qt([n_embd], nq, L),
        },
    }
    if gguf_layout:
        params["layers"]["wqkv_cat"] = params["layers"].pop("wqkv")
    if dense_ffn:
        if cfg.ffn_gate and gguf_layout:
            params["layers"]["ffn_up"] = qt([2 * n_ff], n_embd, L, n_out=2 * n_ff)
        elif cfg.ffn_gate:
            params["layers"]["ffn_gateup"] = qt([n_ff, n_ff], n_embd, L)
        else:
            params["layers"]["ffn_up"] = qt([n_ff], n_embd, L, n_out=n_ff)
        params["layers"]["ffn_down"] = qt([n_embd], n_ff, L)
    layers = params["layers"]
    if cfg.parallel_residual:
        del layers["ffn_norm"]
    normal = lambda n, std, lead=L: torch.from_numpy(
        rng.normal(0.0, std, lead + (n,)).astype(np.float32)).to(device)
    if cfg.attn_qk_norm:
        layers["q_norm"] = 1.0 + normal(head_dim, 0.1)
        layers["k_norm"] = 1.0 + normal(head_dim, 0.1)
    if cfg.attn_bias:
        layers["bq"], layers["bk"], layers["bv"] = (normal(n, 0.5) for n in (nq, nkv, nkv))
    if cfg.post_norms:
        layers["post_attn_norm"] = 1.0 + normal(n_embd, 0.1)
        layers["post_ffn_norm"] = 1.0 + normal(n_embd, 0.1)
    norms = [k for k in ("attn_norm", "ffn_norm") if k in layers]
    layernorm = cfg.norm_type == "layernorm"
    if layernorm:
        for k in norms:
            layers[k] = 1.0 + normal(n_embd, 0.1)
        params["output_norm"] = 1.0 + normal(n_embd, 0.1, ())
    if layernorm and cfg.attn_bias:
        for k in norms:
            layers[k + "_b"] = normal(n_embd, 0.1)
        params["output_norm_b"] = normal(n_embd, 0.1, ())
        layers["bo"] = normal(n_embd, 0.1)
        if dense_ffn:
            layers["ffn_up_b"] = normal(n_ff, 0.1)
            layers["ffn_down_b"] = normal(n_embd, 0.1)
    if n_ctx:
        params["pos_embd"] = normal(n_embd, 0.02, (n_ctx,))
    if tok_norm:
        params["tok_norm"] = 1.0 + normal(n_embd, 0.1, ())
        if cfg.attn_bias:
            params["tok_norm_b"] = normal(n_embd, 0.1, ())
    if gguf_layout:
        params["layers"] = fuse_layer_weights(params["layers"], cfg)
    return cfg, params


def synth_moe_q4k(*, arch: str = "mixtral", vocab_size: int, n_embd: int, n_layer: int,
                  n_head: int, n_head_kv: int, n_ff: int, n_expert: int, n_expert_used: int,
                  n_ff_exp: int | None = None, head_dim: int | None = None,
                  down_qtype: GGMLType = GGMLType.Q4_K, n_ff_shexp: int = 0,
                  rope_base: float = 1e6, rms_eps: float = 1e-5, exact_vocab: bool = False,
                  seed: int = 0, device="cuda", n_dense_lead: int = 0,
                  probs_b_std: float = 0.0, shexp_gate: bool = True, tied: bool = False,
                  cfg_fields: dict | None = None, generator: torch.Generator | None = None,
                  n_group_experts: int = 0, n_ff_chexp: int = 0,
                  expert_group_scale: float = 1.0):
    """-> (ModelConfig, params) of a routed-expert Q4_K model of ``arch`` on
    ``device``.

    Attention, norms and embeddings are synth_kmajor_q4k_fast's
    (centred=True, ``head_dim``, the arch row's q/k norms or biases,
    ``tied``) from ``seed``. Each MoE layer's experts are random_kmajor
    draws with lead (E,),
    from a torch.Generator seeded with ``seed`` on ``device``, written into
    preallocated (L, E, ...) arrays, so the largest transient is one layer's
    draw: gate and up Q4_K, down ``down_qtype`` (Q6_K where Q4_K has no K
    tile at the expert width, as a Q4_K_M file gives some layers). The
    experts are ``n_ff_exp`` wide, the GGUF's expert_feed_forward_length
    (cfg.n_ff_exp), or with None ``n_ff`` wide (Mixtral's GGUF carries no
    expert width). The router is F32 dense (E, n_embd) per layer, normal
    with std 0.02 (logits of std ~1.3 for unit-RMS inputs at n_embd 4096).
    With ``n_ff_shexp`` the MoE layers also carry a Q4_K shared expert of
    that width and (``shexp_gate``) its F32 gate vector (normal, std 0.02),
    drawn in that order after the routed experts; ``shexp_gate=False``
    leaves the gate out, as the files of ernie4_5-moe, glm4moe and the
    deepseek family have it (the shared expert added ungated).

    ``n_dense_lead`` > 0 makes the first n_dense_lead layers dense (a fused
    Q4_K gate/up of ``n_ff`` and its down), as a file's
    leading_dense_block_count does: params["layers"] is then the loader's
    two groups, {"__groups__": [dense lead, MoE layers]}, the attention and
    norms of both cut from one draw over n_layer layers, the experts,
    router and shared expert drawn for the MoE layers alone. The dense
    FFN is drawn after every array above, from the same torch.Generator;
    then, with ``probs_b_std`` > 0, each MoE layer's router selection bias
    ``moe_probs_b`` (E,) f32, normal with that std. ``cfg_fields`` sets
    config fields as a file's keys would, before the row's defaults apply
    (expert_weights_norm, expert_gating, ...). ``n_group_experts`` > 0 adds
    grovemoe's chunk-expert bank, drawn after every array above: E //
    n_group_experts chunk experts of ``n_ff_chexp``, gate and up Q4_K at K
    n_embd, down Q8_0 (llama.cpp's fallback for a Q6_K row whose K is not a
    multiple of 256) at K n_ff_chexp, each K-major where the kernels take
    its K and planar otherwise, as a file loads (_mla_weight: GroveMoE's
    down at K 128 is planar); the config gets the group size,
    the chunk width and ``expert_group_scale``. With the defaults every draw
    is as it was. The registry row of ``arch`` sets the top-k
    renormalization; rope_base defaults to Mixtral's and Qwen's rope_theta,
    1e6. ``generator`` (a torch.Generator on ``device``) draws the
    attention's and the embedding's Q4_K weights on the device
    (synth_kmajor_q4k_fast's option) in place of numpy; the experts' draws
    do not move."""
    cfg, params = synth_kmajor_q4k_fast(
        vocab_size=vocab_size, n_embd=n_embd, n_layer=n_layer, n_head=n_head,
        n_head_kv=n_head_kv, n_ff=n_ff, seed=seed, centred=True, device=device,
        dense_ffn=False, arch="llama" if arch == "mixtral" else arch, rms_eps=rms_eps,
        exact_vocab=exact_vocab, head_dim=head_dim, tied=tied, generator=generator)
    device = params["output_norm"].device
    gen = torch.Generator(device=device).manual_seed(seed)
    E, width = n_expert, n_ff_exp or n_ff
    n_moe = n_layer - n_dense_lead
    if not 0 <= n_dense_lead < n_layer:
        raise ValueError(f"n_dense_lead {n_dense_lead} of {n_layer} layers")

    def stacked(qtype, parts, K, lead=(), n=n_moe):
        """random_kmajor draws of lead per layer, into (n,) + lead arrays."""
        first = random_kmajor(qtype, parts, K, lead, gen, device)
        data = {k: torch.empty((n,) + tuple(v.shape), dtype=v.dtype, device=device)
                for k, v in first.data.items()}
        for li in range(n):
            qt = first if li == 0 else random_kmajor(qtype, parts, K, lead, gen, device)
            for k, v in qt.data.items():
                data[k][li] = v
            del qt
        return QTensor(qtype, (n,) + lead + (sum(pad256(p) for p in parts), K), data)

    layers = params["layers"]
    moe = {"moe_gate_inp": QTensor(GGMLType.F32, (n_moe, E, n_embd), {
        "w": torch.randn((n_moe, E, n_embd), generator=gen, device=device) * 0.02})}
    moe["moe_gate_exps"] = stacked(GGMLType.Q4_K, [width], n_embd, (E,))
    moe["moe_up_exps"] = stacked(GGMLType.Q4_K, [width], n_embd, (E,))
    moe["moe_down_exps"] = stacked(GGMLType(down_qtype), [n_embd], width, (E,))
    if n_ff_shexp:
        moe["ffn_gate_shexp"] = stacked(GGMLType.Q4_K, [n_ff_shexp], n_embd)
        moe["ffn_up_shexp"] = stacked(GGMLType.Q4_K, [n_ff_shexp], n_embd)
        moe["ffn_down_shexp"] = stacked(GGMLType.Q4_K, [n_embd], n_ff_shexp)
        if shexp_gate:
            moe["moe_gate_inp_shexp"] = torch.randn((n_moe, n_embd), generator=gen,
                                                    device=device) * 0.02
    dense = {}
    if n_dense_lead:
        dense["ffn_gateup"] = stacked(GGMLType.Q4_K, [n_ff, n_ff], n_embd, n=n_dense_lead)
        dense["ffn_down"] = stacked(GGMLType.Q4_K, [n_embd], n_ff, n=n_dense_lead)
    if probs_b_std:
        moe["moe_probs_b"] = torch.randn((n_moe, E), generator=gen, device=device) * probs_b_std
    if n_group_experts:
        lead = (n_moe, E // n_group_experts)
        moe.update({"moe_gate_chexps": _mla_weight(n_ff_chexp, n_embd, lead, gen, device,
                                                   GGMLType.Q4_K),
                    "moe_up_chexps": _mla_weight(n_ff_chexp, n_embd, lead, gen, device,
                                                 GGMLType.Q4_K),
                    "moe_down_chexps": _mla_weight(n_embd, n_ff_chexp, lead, gen, device,
                                                   GGMLType.Q8_0)})
    if n_dense_lead:
        cut = lambda v, lo, hi: (QTensor(v.qtype, (hi - lo,) + tuple(v.shape[1:]), {
            k: d[lo:hi] for k, d in v.data.items()}) if isinstance(v, QTensor) else v[lo:hi])
        params["layers"] = {"__groups__": [
            {**{k: cut(v, 0, n_dense_lead) for k, v in layers.items()}, **dense},
            {**{k: cut(v, n_dense_lead, n_layer) for k, v in layers.items()}, **moe}]}
    else:
        layers.update(moe)
    cfg = dataclasses.replace(cfg, arch=arch, n_expert=E, n_expert_used=n_expert_used,
                              n_ff_exp=n_ff_exp or 0, rope_base=rope_base,
                              n_layer_dense_lead=n_dense_lead, **(cfg_fields or {}))
    if n_group_experts:
        cfg = dataclasses.replace(cfg, n_group_experts=n_group_experts, n_ff_chexp=n_ff_chexp,
                                  expert_group_scale=expert_group_scale)
    apply_arch_defaults(cfg)
    return cfg, params


def jax_synth_xielu(n_layer: int) -> tuple:
    """apertus's folded xIELU parameters from the arrays the JAX synth
    writes (tpullm/utils/synth.py:2249-2253)."""
    li = np.arange(n_layer)
    return xielu_params((0.8 + 0.02 * li).astype(np.float32), (0.8 - 0.01 * li).astype(np.float32),
                        np.full(n_layer, 0.5, np.float32), np.full(n_layer, -1e-6, np.float32),
                        n_layer)


def _mla_weight(n: int, K: int, lead: tuple, gen: torch.Generator, device,
                qtype: GGMLType | None = None) -> QTensor:
    """One (lead..., n, K) weight of an MLA model as a Q4_K_M file holds it:
    Q4_K where K is a multiple of 256, else Q8_0 (llama.cpp's fallback for
    such rows), or ``qtype`` (Q4_K, Q8_0 or TQ2_0) where given; K-major where the
    kernels take K (pick_tile_k), else planar,
    as the loader lays it out. Drawn on ``device`` with ``gen``, centred as
    random_kmajor draws (a planar Q4_K group's sub-min round(7.5 * sc) with
    dmin = d; a planar TQ2_0 block's 256 trits uniform over -1, 0 and 1)."""
    from ..ops.qmm import qmm_supported

    if qtype is None:
        qtype = GGMLType.Q4_K if K % 256 == 0 else GGMLType.Q8_0
    if qmm_supported(qtype, K):
        qt = random_kmajor(qtype, [n], K, lead, gen, device)
        return QTensor(qtype, lead + (n, K), qt.data)
    d = lambda nb, scale: ((torch.rand(lead + (n, nb), generator=gen, device=device) + 0.5)
                           * scale).to(torch.float16)
    ints = lambda lo, hi, shape, dt: torch.randint(lo, hi, lead + (n,) + shape, generator=gen,
                                                   device=device, dtype=torch.int16).to(dt)
    if qtype == GGMLType.Q8_0:
        nb = K // 32
        data = {"qs": ints(-128, 128, (nb, 32), torch.int8), "d": d(nb, _RANDOM[qtype]["d"])}
    elif qtype == GGMLType.TQ2_0:  # 2-bit fields t + 1: each byte's 4 at shifts 0, 2, 4, 6
        nb = K // 256
        t = ints(0, 3, (nb, 4, 64), torch.uint8)
        data = {"qs": t[..., 0, :] | (t[..., 1, :] << 2) | (t[..., 2, :] << 4)
                | (t[..., 3, :] << 6), "d": d(nb, _RANDOM[qtype]["d"])}
    else:
        nb = K // 256
        sc = ints(1, 8, (nb, 8), torch.uint8)
        dd = d(nb, _RANDOM[qtype]["d"])
        data = {"qs": ints(0, 256, (nb, 128), torch.uint8), "sc": sc,
                "mn": torch.round(sc.to(torch.float32) * 7.5).to(torch.uint8), "d": dd,
                "dmin": dd.clone()}
    return QTensor(qtype, lead + (n, K), data)


def synth_mla_q4k(*, arch: str = "deepseek2", vocab_size: int, n_embd: int, n_layer: int,
                  n_head: int, kv_lora_rank: int, qk_nope: int, qk_rope: int, v_head: int,
                  n_ff: int, q_lora_rank: int = 0, n_expert: int = 0, n_expert_used: int = 0,
                  n_ff_exp: int = 0, n_ff_shexp: int = 0, n_expert_shared: int = 1,
                  n_dense_lead: int = 0, rope_base: float = 1e4, rms_eps: float = 1e-6,
                  seed: int = 0, device="cuda", cfg_fields: dict | None = None):
    """-> (ModelConfig, params) of an MLA model of ``arch`` (the deepseek2
    family) on ``device``, as the loader gives a split attn_k_b/attn_v_b
    file: each layer's q path (``q_lora_rank`` 0: a direct wq; else wq_a,
    its f32 norm q_a_norm and wq_b), wkv_a with its f32 kv_a_norm, the
    absorption banks wk_b (L, H, kv_lora, qk_nope) and wv_b (L, H, v_head,
    kv_lora) in dense f32 (normal, std 1/sqrt(kv_lora)), wo; the norms
    (the MLA ones 1 + N(0, 0.1)) as synth_kmajor_q4k_fast has them, an
    untied Q4_K embedding and lm_head of vocab_size logical rows. With
    ``n_expert`` the layers past ``n_dense_lead`` are MoE (an F32 router of
    std 0.02, experts of ``n_ff_exp``, a shared expert of ``n_ff_shexp``
    where given, the GGUF's ``n_expert_shared`` experts written as one,
    its gate/up/down unfused and ungated, as the deepseek family's files
    have it); the dense layers a gate/up of ``n_ff`` (fused where
    K-major) and its down. params["layers"] is then the loader's two
    groups, {"__groups__": [dense lead, MoE layers]}.

    Every weight takes _mla_weight's type and layout: Q4_K, Q8_0 where K is
    not a multiple of 256 (DeepSeek-V2-Lite's expert down at K 1408, its
    dense down at 10944), planar where no K-major tile fits (those two, and
    the shared expert's down at K 2816). Everything is drawn with one
    torch.Generator seeded with ``seed`` on ``device``, so no host array
    holds a weight. ``cfg_fields`` sets config fields as a file's keys
    would, before the row's defaults apply (YaRN's rope_scaling,
    rope_scale, rope_orig_ctx and rope_yarn_log_mul, expert_weights_norm,
    expert_weights_scale, ...)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    head_dim = qk_nope + qk_rope
    H, lora, L = n_head, kv_lora_rank, (n_layer,)
    if not 0 <= n_dense_lead <= n_layer or (n_expert and n_dense_lead == n_layer):
        raise ValueError(f"n_dense_lead {n_dense_lead} of {n_layer} layers")
    w = lambda n, K, lead=L: _mla_weight(n, K, lead, gen, device)
    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=device)
    near1 = lambda *s: 1.0 + 0.1 * torch.randn(s, generator=gen, device=device)
    embd, out = (QTensor(GGMLType.Q4_K, (vocab_size, n_embd), random_kmajor(
        GGMLType.Q4_K, [vocab_size], n_embd, (), gen, device).data) for _ in range(2))
    layers = {"attn_norm": ones(n_layer, n_embd), "ffn_norm": ones(n_layer, n_embd)}
    if q_lora_rank:
        layers["wq_a"] = w(q_lora_rank, n_embd)
        layers["q_a_norm"] = near1(n_layer, q_lora_rank)
        layers["wq_b"] = w(H * head_dim, q_lora_rank)
    else:
        layers["wq"] = w(H * head_dim, n_embd)
    layers["wkv_a"] = w(lora + qk_rope, n_embd)
    layers["kv_a_norm"] = near1(n_layer, lora)
    std = lora ** -0.5
    layers["wk_b"] = torch.randn((n_layer, H, lora, qk_nope), generator=gen, device=device) * std
    layers["wv_b"] = torch.randn((n_layer, H, v_head, lora), generator=gen, device=device) * std
    layers["wo"] = w(n_embd, H * v_head)
    n_moe = n_layer - n_dense_lead if n_expert else 0
    dense = {}
    if n_layer - n_moe:  # gate/up fused where K-major, as fuse_layer_weights fuses them
        n_d = (n_layer - n_moe,)
        gate = w(n_ff, n_embd, n_d)
        if gate.layout == "kmajor":
            gu = random_kmajor(gate.qtype, [n_ff, n_ff], n_embd, n_d, gen, device)
            dense["ffn_gateup"] = QTensor(gate.qtype, n_d + (pad256(n_ff) * 2, n_embd), gu.data)
        else:
            dense["ffn_gate"], dense["ffn_up"] = gate, w(n_ff, n_embd, n_d)
        dense["ffn_down"] = w(n_embd, n_ff, n_d)
    moe = {}
    if n_moe:
        LE = (n_moe, n_expert)
        moe["moe_gate_inp"] = QTensor(GGMLType.F32, LE + (n_embd,), {
            "w": torch.randn(LE + (n_embd,), generator=gen, device=device) * 0.02})
        moe["moe_gate_exps"] = w(n_ff_exp, n_embd, LE)
        moe["moe_up_exps"] = w(n_ff_exp, n_embd, LE)
        moe["moe_down_exps"] = w(n_embd, n_ff_exp, LE)
        if n_ff_shexp:
            moe["ffn_gate_shexp"] = w(n_ff_shexp, n_embd, (n_moe,))
            moe["ffn_up_shexp"] = w(n_ff_shexp, n_embd, (n_moe,))
            moe["ffn_down_shexp"] = w(n_embd, n_ff_shexp, (n_moe,))
    cut = lambda v, lo, hi: (QTensor(v.qtype, (hi - lo,) + tuple(v.shape[1:]), {
        k: d[lo:hi] for k, d in v.data.items()}) if isinstance(v, QTensor) else v[lo:hi])
    if dense and moe:
        groups = [{**{k: cut(v, 0, n_dense_lead) for k, v in layers.items()}, **dense},
                  {**{k: cut(v, n_dense_lead, n_layer) for k, v in layers.items()}, **moe}]
        params_layers = {"__groups__": groups}
    else:
        params_layers = {**layers, **dense, **moe}
    cfg = ModelConfig(
        arch=arch, vocab_size=vocab_size, n_embd=n_embd, n_layer=n_layer, n_head=n_head,
        n_head_kv=1, head_dim=head_dim, head_dim_v=v_head, n_ff=n_ff, rope_dim=qk_rope,
        rope_base=rope_base, rms_eps=rms_eps, q_lora_rank=q_lora_rank,
        kv_lora_rank=kv_lora_rank, n_expert=n_expert, n_expert_used=n_expert_used,
        n_ff_exp=n_ff_exp, n_layer_dense_lead=n_dense_lead if n_expert else 0,
        n_expert_shared=n_expert_shared if n_ff_shexp else 0, **(cfg_fields or {}))
    apply_arch_defaults(cfg)
    return cfg, {"tok_embd": embd, "output": out, "output_norm": ones(n_embd),
                 "layers": params_layers}


def _gptoss_weight(qtype: GGMLType, n: int, K: int, lead: tuple, gen: torch.Generator,
                   device) -> QTensor:
    """One (lead..., n, K) weight of a gpt-oss file: K-major where the
    kernels take K (pick_tile_k), else planar, as the loader lays it out;
    Q8_0 or MXFP4, drawn on ``device`` with ``gen``. A planar MXFP4 block's
    e8m0 byte is drawn in [119, 122) (the scale 2^(e - 128) times the
    doubled LUT values, RMS ~5.9: a weight std near 1/sqrt(2880)), its 16
    code bytes uniform; a planar Q8_0 block as _mla_weight draws it."""
    from ..ops.qmm import qmm_supported

    if qmm_supported(qtype, K):
        qt = random_kmajor(qtype, [n], K, lead, gen, device)
        return QTensor(qtype, lead + (n, K), qt.data)
    if qtype == GGMLType.Q8_0:
        return _mla_weight(n, K, lead, gen, device)
    nb = K // 32
    ints = lambda lo, hi, shape: torch.randint(lo, hi, lead + (n,) + shape, generator=gen,
                                               device=device, dtype=torch.uint8)
    return QTensor(qtype, lead + (n, K), {"qs": ints(0, 256, (nb, 16)), "e": ints(119, 122, (nb,))})


def synth_gptoss(*, vocab_size: int, n_embd: int, n_layer: int, n_head: int, n_head_kv: int,
                 head_dim: int, n_expert: int, n_expert_used: int, n_ff_exp: int,
                 sliding_window: int = 0, swa_layer_pattern: tuple = (),
                 rope_base: float = 150000.0, rms_eps: float = 1e-5, seed: int = 0,
                 device="cuda", cfg_fields: dict | None = None):
    """-> (ModelConfig, params) of a gpt-oss model (arch gpt-oss: the
    clamped swiglu_oai, q/k/v and output biases, per-head attention sinks,
    routed experts with the router's bias and each expert's gate, up and
    down biases) on ``device``, as the loader gives a gpt-oss file: MXFP4
    experts (n_expert of n_ff_exp, top n_expert_used), Q8_0 attention
    projections, embedding and untied lm_head of vocab_size rows, each
    K-major where the kernels take its K and planar where no K-major tile
    fits (gpt-oss-20b's K 2880: the experts, q/k/v, the embedding and the
    lm_head; wo at K n_head * head_dim = 4096 is K-major), q/k/v fused by
    the loader's fuse step where K-major; the norms 1 + N(0, 0.1), the
    biases N(0, 0.02) (the experts' N(0, 0.05)), the sinks N(0, 1), the F32
    router N(0, 0.02) with its bias N(0, 0.1). ``sliding_window`` and
    ``swa_layer_pattern`` (one flag a layer: the per-layer array with
    swa_pattern 2, as config_from_gguf parses it) set the windows;
    ``cfg_fields`` sets config fields as a file's keys would (YaRN,
    expert_weights_norm, ...). Everything is drawn with one
    torch.Generator seeded with ``seed`` on ``device``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    L, LE = (n_layer,), (n_layer, n_expert)
    nq, nkv = n_head * head_dim, n_head_kv * head_dim
    q8 = lambda n, K, lead=L: _gptoss_weight(GGMLType.Q8_0, n, K, lead, gen, device)
    normal = lambda std, *s: torch.randn(s, generator=gen, device=device) * std
    near1 = lambda *s: 1.0 + normal(0.1, *s)
    embd, out = q8(vocab_size, n_embd, ()), q8(vocab_size, n_embd, ())
    layers = {"attn_norm": near1(n_layer, n_embd), "ffn_norm": near1(n_layer, n_embd),
              "wq": q8(nq, n_embd), "wk": q8(nkv, n_embd), "wv": q8(nkv, n_embd),
              "wo": q8(n_embd, nq), "bq": normal(0.02, n_layer, nq),
              "bk": normal(0.02, n_layer, nkv), "bv": normal(0.02, n_layer, nkv),
              "bo": normal(0.02, n_layer, n_embd), "attn_sinks": normal(1.0, n_layer, n_head),
              "moe_gate_inp": QTensor(GGMLType.F32, LE + (n_embd,),
                                      {"w": normal(0.02, *LE, n_embd)}),
              "moe_gate_inp_b": normal(0.1, *LE)}
    for name, n, K in (("gate", n_ff_exp, n_embd), ("up", n_ff_exp, n_embd),
                       ("down", n_embd, n_ff_exp)):
        layers[f"moe_{name}_exps"] = _gptoss_weight(GGMLType.MXFP4, n, K, LE, gen, device)
        layers[f"moe_{name}_exps_b"] = normal(0.05, *LE, n)
    fields = dict(cfg_fields or {})
    if swa_layer_pattern:
        fields.update(swa_layer_pattern=tuple(bool(f) for f in swa_layer_pattern), swa_pattern=2)
    cfg = ModelConfig(
        arch="gpt-oss", vocab_size=vocab_size, n_embd=n_embd, n_layer=n_layer, n_head=n_head,
        n_head_kv=n_head_kv, head_dim=head_dim, head_dim_v=head_dim, n_ff=n_ff_exp,
        rope_dim=head_dim, rope_base=rope_base, rms_eps=rms_eps, n_expert=n_expert,
        n_expert_used=n_expert_used, n_ff_exp=n_ff_exp, sliding_window=sliding_window,
        **fields)
    apply_arch_defaults(cfg)
    return cfg, {"tok_embd": embd, "output": out, "output_norm": near1(n_embd),
                 "layers": fuse_layer_weights(layers, cfg)}


def synth_gemma3n(*, vocab_size: int, n_embd: int, n_layer: int, n_head: int, n_head_kv: int,
                  head_dim: int, n_ff: int, generator: torch.Generator, device="cuda",
                  n_embd_per_layer: int = 256, table_rows: int | None = None,
                  n_layer_kv_from_start: int | None = None, sliding_window: int = 512,
                  rope_base: float = 1e6, rope_base_swa: float = 1e4, rms_eps: float = 1e-6,
                  laurel_rank: int = 64):
    """-> (ModelConfig, params) of a gemma3n model (the registry row: AltUp
    over 4 streams, activation sparsity on the first 10 layers, the final
    softcap of 30, the SWA period 5), every tensor drawn on ``device`` with
    ``generator``. The layer matrices are Q4_K: the fused wqkv of the owning
    layers (the first ``n_layer_kv_from_start``, min(20, n_layer) as
    config_from_gguf fixes it, by default), wq alone on the shared-KV layers,
    wo, the fused gate/up, down and the per-layer input gate K-major; the
    per-layer projection back (K = n_embd_per_layer, 256: Q4_K has no K-major
    tile there) planar. The embedding (tied lm_head) is Q4_K K-major with its
    logical vocab_size rows; the per-layer token table (``table_rows``,
    vocab_size by default, x n_layer * n_embd_per_layer) Q4_K, planar where
    no K-major tile fits (K 8960 at 35 layers); its projection of the input
    Q4_K K-major. The norms are 1 + N(0, 0.1), the per-head q and k norms
    that times head_dim^-1/4: the row's attention scale is 1, so those
    weights set the softmax's temperature (at 1 a score's spread is
    sqrt(head_dim), attention picks one key, and bf16's rounding flips the
    pick: the CPU's bf16 and f32 logits of a 10-layer model at n_embd 1024
    part at NMSE 0.2, against 9e-4 so drawn). AltUp's stream projections
    (A - 1, D, D) and LAuReL's pair N(0, 1/sqrt(K)); the router N(0, 1), the
    coefficients N(0, 0.05), the correction scale 1 + N(0, 0.1), all f32.
    The owning and the shared layers are two layer groups, as the loader
    groups a converted file."""
    device = resolve_device(device)
    P, A, q4k = n_embd_per_layer, 4, GGMLType.Q4_K
    nks = min(20, n_layer) if n_layer_kv_from_start is None else n_layer_kv_from_start
    rows = table_rows or vocab_size
    cfg = ModelConfig(arch="gemma3n", vocab_size=vocab_size, n_embd=n_embd, n_layer=n_layer,
                      n_head=n_head, n_head_kv=n_head_kv, head_dim=head_dim,
                      head_dim_v=head_dim, n_ff=n_ff, rope_dim=head_dim, rope_base=rope_base,
                      rms_eps=rms_eps, tie_embeddings=True, sliding_window=sliding_window,
                      rope_base_swa=rope_base_swa, n_embd_per_layer=P,
                      n_layer_kv_from_start=nks)
    apply_arch_defaults(cfg)
    g = generator
    normal = lambda shape, std: torch.randn(shape, generator=g, device=device) * std
    nq, nkv = n_head * head_dim, n_head_kv * head_dim

    def kq(parts, K, lead):
        qt = random_kmajor(q4k, parts, K, lead, g, device)
        return QTensor(q4k, qt.shape, qt.data)

    def group(L, owners):
        lead = (L,)
        lay = {"attn_norm": 1.0 + normal(lead + (n_embd,), 0.1),
               "ffn_norm": 1.0 + normal(lead + (n_embd,), 0.1),
               "post_attn_norm": 1.0 + normal(lead + (n_embd,), 0.1),
               "post_ffn_norm": 1.0 + normal(lead + (n_embd,), 0.1),
               "q_norm": (1.0 + normal(lead + (head_dim,), 0.1)) * head_dim ** -0.25}
        if owners:
            lay["k_norm"] = (1.0 + normal(lead + (head_dim,), 0.1)) * head_dim ** -0.25
            lay["wqkv"] = kq([nq, nkv, nkv], n_embd, lead)
        else:
            lay["wq"] = QTensor(q4k, lead + (nq, n_embd),
                                random_kmajor(q4k, [nq], n_embd, lead, g, device).data)
        lay["wo"] = kq([n_embd], nq, lead)
        lay["ffn_gateup"] = kq([n_ff, n_ff], n_embd, lead)
        lay["ffn_down"] = kq([n_embd], n_ff, lead)
        lay["per_layer_inp_gate"] = _mla_weight(P, n_embd, lead, g, device, q4k)
        lay["per_layer_proj"] = _mla_weight(n_embd, P, lead, g, device, q4k)
        lay["per_layer_post_norm"] = 1.0 + normal(lead + (n_embd,), 0.1)
        lay["altup_router"] = normal(lead + (A, n_embd), 1.0)
        lay["altup_router_norm"] = 1.0 + normal(lead + (n_embd,), 0.1)
        lay["altup_predict_coef"] = normal(lead + (A * A, A), 0.05)
        lay["altup_correct_coef"] = normal(lead + (A, A), 0.05)
        lay["altup_correct_scale"] = 1.0 + normal(lead + (n_embd,), 0.1)
        lay["laurel_l"] = normal(lead + (laurel_rank, n_embd), n_embd ** -0.5)
        lay["laurel_r"] = normal(lead + (n_embd, laurel_rank), laurel_rank ** -0.5)
        lay["laurel_post_norm"] = 1.0 + normal(lead + (n_embd,), 0.1)
        return lay

    embd = QTensor(q4k, (vocab_size, n_embd), random_kmajor(q4k, [vocab_size], n_embd, (), g,
                                                           device).data)
    groups = [group(nks, True)] + ([group(n_layer - nks, False)] if nks < n_layer else [])
    params = {
        "tok_embd": embd, "output": embd, "output_norm": 1.0 + normal((n_embd,), 0.1),
        "per_layer_tok_embd": _mla_weight(rows, n_layer * P, (), g, device, q4k),
        "per_layer_model_proj": _mla_weight(n_layer * P, n_embd, (), g, device, q4k),
        "per_layer_proj_norm": 1.0 + normal((P,), 0.1),
        "altup_proj": normal((A - 1, n_embd, n_embd), n_embd ** -0.5),
        "altup_unembd_proj": normal((A - 1, n_embd, n_embd), n_embd ** -0.5),
        "layers": groups[0] if len(groups) == 1 else {"__groups__": groups},
    }
    return cfg, params


def synth_dense_single(*, arch: str, vocab_size: int, n_embd: int, n_layer: int, n_head: int,
                       n_head_kv: int, n_ff: int, generator: torch.Generator, device="cuda",
                       qtype: GGMLType = GGMLType.Q4_K, embd_qtype: GGMLType = GGMLType.Q4_K,
                       rope_base: float = 1e4, rms_eps: float = 1e-5, tied: bool = False):
    """-> (ModelConfig, params) of a chameleon or bitnet model as the loader
    holds a converted file, every tensor drawn on ``device`` with
    ``generator``: each layer matrix of ``qtype``, K-major where the kernels
    take its K and planar otherwise (_mla_weight: Chameleon-7B's Q4_K down at
    K 11008, every TQ2_0 matrix of BitNet b1.58 2B-4T at K 2560 and 6912),
    q/k/v and gate/up fused where their parts are K-major (the loader's
    fuse step); the embedding (and an untied lm_head) of ``embd_qtype``,
    K-major over its logical vocab_size rows; the norms 1 + N(0, 0.1).
    The row's own tensors as the JAX synth's hints draw them: chameleon's
    per-head (H, hd) layernorm q/k norms 1 + N(0, 0.1) and their biases
    N(0, 0.1); bitnet's sub-norms 1 + N(0, 0.1) (attn_sub_norm n_embd,
    ffn_sub_norm n_ff) and its seven (1,) per-tensor scales 0.9 + 0.05 li
    (tpullm/utils/synth.py:2318-2327)."""
    device = resolve_device(device)
    cfg = ModelConfig(arch=arch, vocab_size=vocab_size, n_embd=n_embd, n_layer=n_layer,
                      n_head=n_head, n_head_kv=n_head_kv, head_dim=n_embd // n_head,
                      head_dim_v=n_embd // n_head, n_ff=n_ff, rope_dim=n_embd // n_head,
                      rope_base=rope_base, rms_eps=rms_eps, tie_embeddings=tied)
    apply_arch_defaults(cfg)
    g, L, hd = generator, (n_layer,), cfg.head_dim
    near1 = lambda *shape: 1.0 + torch.randn(shape, generator=g, device=device) * 0.1
    w = lambda n, K: _mla_weight(n, K, L, g, device, qtype)
    embd = _mla_weight(vocab_size, n_embd, (), g, device, embd_qtype)
    layers = {"attn_norm": near1(n_layer, n_embd), "ffn_norm": near1(n_layer, n_embd),
              "wq": w(n_head * hd, n_embd), "wk": w(n_head_kv * hd, n_embd),
              "wv": w(n_head_kv * hd, n_embd), "wo": w(n_embd, n_head * hd),
              "ffn_gate": w(n_ff, n_embd), "ffn_up": w(n_ff, n_embd), "ffn_down": w(n_embd, n_ff)}
    if cfg.qk_norm_type == "layernorm":
        layers.update(q_norm=near1(n_layer, n_head, hd), k_norm=near1(n_layer, n_head_kv, hd),
                      q_norm_b=torch.randn((n_layer, n_head, hd), generator=g, device=device)
                      * 0.1, k_norm_b=torch.randn((n_layer, n_head_kv, hd), generator=g,
                                                  device=device) * 0.1)
    if cfg.sub_norms:
        layers.update(attn_sub_norm=near1(n_layer, n_embd), ffn_sub_norm=near1(n_layer, n_ff))
        scale = (0.9 + 0.05 * torch.arange(n_layer, dtype=torch.float32, device=device))[:, None]
        layers.update({k: scale.clone() for k in ("wq_s", "wk_s", "wv_s", "wo_s", "ffn_gate_s",
                                                  "ffn_up_s", "ffn_down_s")})
    out = embd if tied else _mla_weight(vocab_size, n_embd, (), g, device, embd_qtype)
    return cfg, {"tok_embd": embd, "output": out, "output_norm": near1(n_embd),
                 "layers": fuse_layer_weights(layers, cfg)}


def synth_mixtral_q4k(*, vocab_size: int, n_embd: int, n_layer: int, n_head: int,
                      n_head_kv: int, n_ff: int, n_expert: int, n_expert_used: int,
                      seed: int = 0, device="cuda"):
    """-> (ModelConfig, params) of a Mixtral-shaped Q4_K model on ``device``:
    synth_moe_q4k's Mixtral form (experts n_ff wide, all Q4_K, no shared
    expert). cfg.arch is "mixtral", so the top-k weights are renormalized;
    rope_base is Mixtral's rope_theta, 1e6."""
    return synth_moe_q4k(arch="mixtral", vocab_size=vocab_size, n_embd=n_embd,
                         n_layer=n_layer, n_head=n_head, n_head_kv=n_head_kv, n_ff=n_ff,
                         n_expert=n_expert, n_expert_used=n_expert_used, seed=seed,
                         device=device)


# stored-integer ranges [lo, hi) of each K-major type ("q": the grid values
# as pack_kmajor stores them, "s8"/"m8": sub-scales and sub-mins) and a d
# that puts the weights' std near 1/sqrt(4096), as in trained checkpoints
_RANDOM = {
    GGMLType.Q4_0: dict(q=(0, 256), d=4e-3),
    GGMLType.Q4_1: dict(q=(0, 256), d=4e-3),
    GGMLType.Q5_0: dict(q=(0, 32), d=2e-3),
    GGMLType.Q5_1: dict(q=(0, 32), d=2e-3),
    GGMLType.Q8_0: dict(q=(-128, 128), d=2e-4),
    GGMLType.Q2_K: dict(q=(0, 4), s8=(1, 16), d=2e-3),
    GGMLType.Q3_K: dict(q=(-4, 4), s8=(-32, 32), d=4e-4),
    GGMLType.Q4_K: dict(q=(0, 256), s8=(1, 8), d=1e-3),
    GGMLType.Q5_K: dict(q=(0, 32), s8=(1, 4), d=1e-3),
    GGMLType.Q6_K: dict(q=(-32, 32), s8=(-32, 32), d=4e-5),
    GGMLType.IQ4_NL: dict(q=(0, 256), d=2e-4),
    GGMLType.IQ4_XS: dict(q=(0, 256), s8=(-32, 32), d=2e-5),
    GGMLType.MXFP4: dict(q=(0, 256), d=3e-3),
    GGMLType.TQ2_0: dict(q=(-1, 2), d=2e-2),
}


def random_kmajor(qtype: GGMLType, parts: list[int], K: int, lead: tuple = (),
                  generator: torch.Generator | None = None, device="cuda") -> QTensor:
    """A random K-major weight of ``qtype`` for fused parts of n_out
    ``parts`` (each padded to 256), drawn with a torch.Generator on
    ``device``. The weights have mean ~0, like trained ones: affine types
    get a bias that centres the grid (sub-min m8 = round(mid * s8) with
    dmin = d for K-quants, bm = -mid * d for Q4_1/Q5_1)."""
    qtype = GGMLType(qtype)
    spec, rng = KM_SPECS[qtype], _RANDOM[qtype]
    ds = dstore_for(spec, K)
    npad = sum(pad256(p) for p in parts)
    P = 2 if spec.kind == "u4" else 1
    shp = lambda rows: lead + (rows, npad)

    def ints(lo, hi, rows, dtype):
        return torch.randint(lo, hi, shp(rows), generator=generator, device=device,
                             dtype=torch.int16).to(dtype)

    qdt = torch.uint8 if spec.kind == "u4" else torch.int8
    d = (torch.rand(shp(K // ds), generator=generator, device=device) + 0.5) * rng["d"]
    data = {"q": ints(*rng["q"], K // P, qdt), "d": d}
    mid = 7.5 if spec.kind == "u4" else (rng["q"][0] + rng["q"][1] - 1) / 2
    if spec.sb is not None:
        data["s8"] = ints(*rng["s8"], K // spec.gs, torch.int8)
    if spec.bias == "i8d":
        data["m8"] = torch.round(data["s8"].to(torch.float32) * mid).to(torch.int8)
        data["dmin"] = d.clone()
    elif spec.bias == "f32":
        data["bm"] = -mid * d
    return QTensor(qtype, lead + (npad, K), data)


# the chat template of meta-llama/Meta-Llama-3-8B-Instruct (tokenizer_config.json)
LLAMA3_CHAT_TEMPLATE = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + '<|end_header_id|>\\n\\n'"
    "+ message['content'] | trim + '<|eot_id|>' %}"
    "{% if loop.index0 == 0 %}{% set content = bos_token + content %}{% endif %}"
    "{{ content }}{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}"
    "{% endif %}")
# Llama-3's 256 special tokens, from id n_vocab - 256 (128000 at 128256)
_LLAMA3_NAMED = {0: "<|begin_of_text|>", 1: "<|end_of_text|>", 6: "<|start_header_id|>",
                 7: "<|end_header_id|>", 9: "<|eot_id|>"}


# English letter frequencies (%), a-z: the 4-gram tokens are drawn by them
_EN_FREQ = (8.2, 1.5, 2.8, 4.3, 12.7, 2.2, 2.0, 6.1, 7.0, 0.15, 0.8, 4.0, 2.4, 6.7, 7.5, 1.9,
            0.1, 6.0, 6.3, 9.1, 2.8, 1.0, 2.4, 0.15, 2.0, 0.07)


# the chat template of Qwen/Qwen2-7B-Instruct (tokenizer_config.json): ChatML
QWEN2_CHAT_TEMPLATE = (
    "{% for message in messages %}{% if loop.first and messages[0]['role'] != 'system' %}"
    "{{ '<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n' }}{% endif %}"
    "{{'<|im_start|>' + message['role'] + '\n' + message['content'] + '<|im_end|>' + '\n'}}"
    "{% endfor %}{% if add_generation_prompt %}{{ '<|im_start|>assistant\n' }}{% endif %}")
# Qwen2's vocab: 151643 ordinary ids, then <|endoftext|>, <|im_start|>,
# <|im_end|> and reserved ids up to the model's 151936 rows
QWEN2_N_ORDINARY, QWEN2_N_VOCAB = 151643, 151936
_QWEN2_NAMED = {0: "<|endoftext|>", 1: "<|im_start|>", 2: "<|im_end|>"}


def synth_bpe_vocab(n_vocab: int = 128256, pre: str = "llama-bpe", seed: int = 0,
                    layout: str = "llama3") -> Vocab:
    """A byte-level BPE vocab at Llama-3's or Qwen2's layout, built from
    ``seed``.

    Ids 0-255 are the GPT-2 byte tokens. Then come tokens made of lowercase
    ASCII letters, which may start with the space mark "Ġ", each with a
    merge for every split into two shorter such tokens, so that English
    words merge into multi-byte tokens and the rank loop does real work:
    every 2- and 3-letter token, in an order drawn from the seed, then
    4-letter tokens drawn by English letter frequencies, with one in ten
    tokens instead the join of any two tokens. Ranks follow the order
    drawn. The special tokens (control tokens) come last:
    - ``layout="llama3"``: Llama-3's 256, ``<|begin_of_text|>`` (BOS, added),
      ``<|end_of_text|>`` (EOS), ``<|start_header_id|>``,
      ``<|end_header_id|>``, ``<|eot_id|>`` (EOT) and reserved ones, with
      Llama-3's chat template;
    - ``layout="qwen2"``: n_vocab - 293 ordinary ids (151643 at Qwen2's
      151936), then ``<|endoftext|>`` (BOS, not added), ``<|im_start|>``,
      ``<|im_end|>`` (EOS and EOT) and reserved ones, pre-type ``qwen2``,
      with Qwen2's ChatML template."""
    if layout == "qwen2":
        n_special, named, pre = QWEN2_N_VOCAB - QWEN2_N_ORDINARY, _QWEN2_NAMED, "qwen2"
    elif layout == "llama3":
        n_special, named = 256, _LLAMA3_NAMED
    else:
        raise ValueError(f"synth_bpe_vocab: layout {layout!r} is 'llama3' or 'qwen2'")
    base = n_vocab - n_special
    if base < 256:
        raise ValueError(f"n_vocab {n_vocab} leaves no room for the byte tokens")
    rng = np.random.default_rng(seed)
    tokens = [_BYTE_ENC[b] for b in range(256)]
    seen = set(tokens)
    merges = []
    sp = _BYTE_ENC[ord(" ")]
    az = "abcdefghijklmnopqrstuvwxyz"

    def add(t: str, n_split: int = 0) -> None:
        """Token t with a merge for each split after its first n_split
        characters (tokens of the letters; the space mark counts as one)."""
        if len(tokens) < base and t not in seen:
            seen.add(t)
            tokens.append(t)
            merges.extend(f"{t[:k]} {t[k:]}" for k in range(1, len(t)) if k <= n_split
                          or t[:k] in seen and t[k:] in seen)

    for n in (2, 3):
        words = ["".join(c) for c in np.array(np.meshgrid(
            *[list(sp + az)] + [list(az)] * (n - 1), indexing="ij")).reshape(n, -1).T]
        for j in rng.permutation(len(words)):
            add(words[j], n)
    p = np.asarray(_EN_FREQ) / sum(_EN_FREQ)
    while len(tokens) < base:
        letters = rng.choice(26, size=(4096, 4), p=p)
        lead = rng.random(4096) < 0.3  # a word's start: the space mark first
        wide = rng.random((4096, 3))
        for row, sp_first, (w, a, b) in zip(letters, lead, wide):
            if w < 0.1:  # the join of any two tokens
                add(tokens[int(a * len(tokens))] + tokens[int(b * len(tokens))])
            else:
                word = "".join(az[c] for c in row)
                add(sp + word[1:] if sp_first else word, 3)
    reserved = iter(range(n_special))
    for k in range(n_special):
        tokens.append(named.get(k) or f"<|reserved_special_token_{next(reserved)}|>")
    attrs = [TokenAttr.NORMAL] * base + [TokenAttr.CONTROL] * n_special
    if layout == "qwen2":
        v = Vocab(model="gpt2", pre=pre, tokens=tokens, merges=merges, attrs=attrs,
                  bos_id=base, eos_id=base + 2, eot_id=base + 2, add_bos=False,
                  add_space_prefix=False, chat_template=QWEN2_CHAT_TEMPLATE)
    else:
        v = Vocab(model="gpt2", pre=pre, tokens=tokens, merges=merges, attrs=attrs,
                  bos_id=base, eos_id=base + 1, eot_id=base + 9, add_bos=True,
                  add_space_prefix=False, chat_template=LLAMA3_CHAT_TEMPLATE)
    v._build_caches()
    return v
