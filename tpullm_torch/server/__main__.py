"""`python -m tpullm_torch.server -m model.gguf [--host H] [--port P] ...`

The port's llama-server entry point (counterpart of tpullm/server/__main__.py):
loads the GGUF through the port's ``load_model`` onto the card and its vocab
through the port's tokenizer, and serves text, token-id and chat completions
over HTTP (``server/http.py``; a GGUF without a vocab serves token ids
only). Every flag has an
environment fallback (TPULLM_<DEST>) and can come from a --preset JSON
profile (``utils/args.py``). Flags of the JAX server whose features are not
ported (downloads, LoRA, multimodal, speculation, slot files) raise instead
of being ignored. As the JAX server does, a model with sliding-window
layers gets the iSWA dual cache (a ring of window + --prefill-chunk slots
on its SWA layers) unless --swa-full is passed; the int8 cache
(--kv-type q8) has no ring and stays full-context on every layer.
"""
import logging
import sys

from ..utils.args import ArgLayer

# flags of the JAX server whose features the port does not have yet
NOT_PORTED = {"hf_repo": "--hf-repo", "hf_file": "--hf-file", "model_url": "--model-url",
              "lora": "--lora", "mmproj": "--mmproj", "spec": "--spec",
              "model_draft": "--model-draft", "slot_save_path": "--slot-save-path",
              "override_kv": "--override-kv"}


def build_args():
    ap = ArgLayer("tpullm_torch.server")
    ap.add("-m", "--model", default=None, help="GGUF checkpoint path")
    ap.add("-hf", "--hf-repo", default=None, help="not ported (no downloads)")
    ap.add("--hf-file", default=None, help="not ported (no downloads)")
    ap.add("-mu", "--model-url", default=None, help="not ported (no downloads)")
    ap.add("--host", default="127.0.0.1")
    ap.add("--port", type=int, default=8080)
    ap.add("-c", "--ctx-size", type=int, default=2048)
    ap.add("-np", "--parallel", type=int, default=4, help="slots")
    ap.add("--decode-chunk", type=int, default=8)
    ap.add("--prefill-chunk", type=int, default=512)
    ap.add("--alias", default=None, help="model name in the API")
    ap.add("--lora", action="append", default=[], help="not ported")
    ap.add("--kv-type", default="bf16", choices=("bf16", "f32", "q8"),
           help="KV cache storage type")
    ap.add("--spec", default=None, choices=("ngram", "draft"), help="not ported")
    ap.add("-md", "--model-draft", default=None, help="not ported")
    ap.add("--override-kv", action="append", default=[], help="not ported")
    ap.add("--slot-save-path", default=None, help="not ported")
    ap.add("--mmproj", default=None, help="not ported")
    ap.add("--swa-full", action="store_true",
           help="full-context KV for SWA layers (the reference's --swa-full) instead of "
                "the window + prefill-chunk ring of the iSWA cache")
    ap.add("--log-level", default=None, help="debug|info|warning|error")
    return ap


def main(argv=None):
    args = build_args().parse(argv)
    for dest, flag in NOT_PORTED.items():
        if getattr(args, dest):
            raise NotImplementedError(f"{flag}: not ported to tpullm_torch yet")
    if not args.model:
        raise SystemExit("tpullm_torch.server: -m/--model is required")
    import torch

    from ..runtime.loader import load_model
    from ..tokenizer import Tokenizer
    from .context import ServerContext
    from .http import serve

    logging.basicConfig(level=(args.log_level or "info").upper())
    log = logging.getLogger("tpullm_torch.server")
    log.info("loading %s ...", args.model)
    cfg, params, g = load_model(args.model, device="cuda")
    tok = Tokenizer.from_gguf(g) if g.get("tokenizer.ggml.tokens") else None
    kv_dtype = {"bf16": torch.bfloat16, "f32": torch.float32, "q8": "q8"}[args.kv_type]
    ctx = ServerContext(cfg, params, tok, n_slots=args.parallel, max_seq_len=args.ctx_size,
                        decode_chunk=args.decode_chunk, prefill_chunk=args.prefill_chunk,
                        model_name=args.alias or args.model.rsplit("/", 1)[-1],
                        kv_dtype=kv_dtype, iswa=not args.swa_full, device="cuda")
    cache = ctx.memory.cache
    log.info("serving %s on http://%s:%s (%d slots, ctx %d, kv %s%s; %s)", cfg.arch,
             args.host, args.port, args.parallel, args.ctx_size, args.kv_type,
             f", iSWA ring of {cache.ring} slots" if cache.dual else "",
             f"{tok.vocab.model} tokenizer, {tok.vocab.n_tokens} tokens" if tok else
             "no vocab in the file: token-id prompts only")
    serve(ctx, args.host, args.port)


if __name__ == "__main__":
    sys.exit(main())
