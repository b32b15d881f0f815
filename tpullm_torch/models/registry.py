"""Architecture registry of the PyTorch port: per-arch defaults.

Counterpart of tpullm/models/registry.py, holding only the archs the port
runs. Rows are DEFAULTS: a value the GGUF set explicitly wins.
"""
from __future__ import annotations

ARCH_REGISTRY: dict[str, dict] = {
    # rope_type: "norm" = interleaved pairs (ggml GGML_ROPE_TYPE_NORM)
    "llama": dict(rope_type="norm"),
    # mixtral (llama MoE branch, src/models/llama.cpp:208): top-k
    # router weights are RENORMALIZED (build_moe_ffn norm_w=true). The
    # "llama" row has no such default, as in the JAX registry, so a llama
    # GGUF with experts is computed without renormalization there and here.
    "mixtral": dict(rope_type="norm", expert_weights_norm=True),
}


def get_arch(name: str) -> dict:
    return ARCH_REGISTRY.get(name, {})


def apply_arch_defaults(cfg) -> None:
    import dataclasses

    field_defaults = {f.name: f.default for f in dataclasses.fields(type(cfg))}
    for k, v in get_arch(cfg.arch).items():
        if k in field_defaults and getattr(cfg, k) != field_defaults[k]:
            continue  # GGUF-provided value takes precedence
        if k == "embedding_scale" and v == -1.0:
            cfg.embedding_scale = float(cfg.n_embd) ** 0.5
        else:
            setattr(cfg, k, v)
