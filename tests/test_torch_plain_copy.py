"""chip_smoke.py's CPU reference: ``plain_cpu_copy`` dequantizes each K-major
weight once to a dense f32 QTensor held in K-major memory order. The plain
path must give the same bits on that copy as on the K-major weights it
replaces (each dequantized per call), so the parity phases hold the card to
the same reference either way. Checked per weight (a layer of a stacked
weight, an expert of an (L, E) stack as ``_expert_mm`` takes it, the
lm_head) and through ``forward``, in f32 and bf16."""
import pytest
import torch

from chip_smoke import plain_cpu_copy
from tpullm_torch.models.llama import KVCache, expert_weight, forward
from tpullm_torch.ops.qmm import qmm
from tpullm_torch.ops.qtensor import QTensor
from tpullm_torch.utils.synth import synth_kmajor_q4k_fast, synth_mixtral_q4k

torch.set_num_threads(2)

DTYPES = [torch.float32, torch.bfloat16]


def _model(kind):
    kw = dict(vocab_size=300, n_embd=512, n_layer=2, n_head=4, n_head_kv=2, n_ff=768,
              seed=4, device="cpu")
    if kind == "mixtral":
        return synth_mixtral_q4k(n_expert=4, n_expert_used=2, **kw)
    return synth_kmajor_q4k_fast(centred=True, **kw)


def _pairs(cfg, params, cpu):
    """(name, K-major QTensor, its copy, layer) for every K-major weight."""
    out = [("output", params["output"], cpu["output"], None)]
    for name, qt in params["layers"].items():
        if not isinstance(qt, QTensor) or qt.layout != "kmajor":
            continue
        dense = cpu["layers"][name]
        assert dense.layout == "dense" and dense.data["w"].dtype == torch.float32, name
        for li in range(cfg.n_layer):
            if qt.data["q"].dim() == 4:  # (L, E, ...) experts
                out += [(f"{name}[{li},{e}]", expert_weight(qt, li, e),
                         expert_weight(dense, li, e), None) for e in range(cfg.n_expert)]
            else:
                out.append((f"{name}[{li}]", qt, dense, li))
    return out


@pytest.mark.parametrize("kind", ["llama", "mixtral"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_qmm_on_plain_cpu_copy_bit_identical(kind, dtype):
    cfg, params = _model(kind)
    cpu = plain_cpu_copy(torch, params)
    assert cpu["tok_embd"].layout == "kmajor"  # looked up by rows, kept as it is
    g = torch.Generator().manual_seed(0)
    pairs = _pairs(cfg, params, cpu)
    assert len(pairs) > (cfg.n_layer * cfg.n_expert * 3 if kind == "mixtral" else 4)
    for name, qt, dense, li in pairs:
        for M in (1, 5):
            x = torch.randn((M, qt.n_in), generator=g).to(dtype)
            a = qmm(x, qt, dtype, li)
            b = qmm(x, dense, dtype, li)
            assert a.shape == b.shape == (M, qt.n_out), name
            assert torch.equal(a, b), (name, M, float((a.float() - b.float()).abs().max()))


@pytest.mark.parametrize("kind", ["llama", "mixtral"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_on_plain_cpu_copy_bit_identical(kind, dtype):
    """A 24-token prefill of two rows (one left-padded) and 2 decode steps:
    the same logits bit for bit on the K-major model and on its copy."""
    cfg, params = _model(kind)
    cpu = plain_cpu_copy(torch, params)
    g = torch.Generator().manual_seed(1)
    B, T, S = 2, 24, 64
    tok = torch.randint(0, cfg.vocab_size, (B, T), generator=g)
    pos = torch.stack([torch.arange(T), (torch.arange(T) - 5).clamp_min(0)])
    vf = torch.tensor([0, 5])
    logits = {}
    with torch.inference_mode():
        for name, p in (("kmajor", params), ("copy", cpu)):
            cache = KVCache.create(cfg, B, S, dtype, "cpu")
            lg, _ = forward(p, cfg, tok, pos, cache, 0, vf, dtype)
            steps = [lg[:, -1].float()]
            nxt, cp = steps[-1].argmax(-1), pos[:, -1] + 1
            for step in range(2):
                lg, _ = forward(p, cfg, nxt[:, None], cp[:, None], cache, T + step, vf, dtype,
                                kv_view_len=S)
                steps.append(lg[:, -1].float())
                nxt, cp = steps[-1].argmax(-1), cp + 1
            logits[name] = torch.stack(steps)
    assert torch.isfinite(logits["copy"]).all()
    assert torch.equal(logits["kmajor"], logits["copy"])
