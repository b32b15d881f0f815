"""Chat-template application.

The port's copy of tpullm/server/chat.py: the GGUF's own
``tokenizer.chat_template`` runs on the bundled Jinja subset (``jinja.py``);
where there is none, or it does not render, built-in renderers for the
common families are picked by template fingerprint or arch (the detection
idea of common/chat.cpp). Media content parts (images, audio) need the
multimodal projectors, which are not ported: they raise
``NotImplementedError`` (the HTTP front end answers 501).
"""
from __future__ import annotations


def _llama3(messages):
    out = "<|begin_of_text|>"
    for m in messages:
        out += f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n{m['content']}<|eot_id|>"
    out += "<|start_header_id|>assistant<|end_header_id|>\n\n"
    return out


def _chatml(messages):
    out = ""
    for m in messages:
        out += f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n"
    out += "<|im_start|>assistant\n"
    return out


def _llama2(messages):
    sys_txt = ""
    out = ""
    msgs = list(messages)
    if msgs and msgs[0]["role"] == "system":
        sys_txt = msgs.pop(0)["content"]
    first = True
    for m in msgs:
        if m["role"] == "user":
            body = m["content"]
            if first and sys_txt:
                body = f"<<SYS>>\n{sys_txt}\n<</SYS>>\n\n{body}"
            out += f"[INST] {body} [/INST]"
            first = False
        elif m["role"] == "assistant":
            out += f" {m['content']} "
    return out


def _gemma(messages):
    out = ""
    for m in messages:
        role = "model" if m["role"] == "assistant" else m["role"]
        out += f"<start_of_turn>{role}\n{m['content']}<end_of_turn>\n"
    out += "<start_of_turn>model\n"
    return out


def _zephyr(messages):
    out = ""
    for m in messages:
        out += f"<|{m['role']}|>\n{m['content']}</s>\n"
    out += "<|assistant|>\n"
    return out


def _plain(messages):
    out = ""
    for m in messages:
        out += f"{m['role']}: {m['content']}\n"
    out += "assistant: "
    return out


_FINGERPRINTS = [
    ("<|start_header_id|>", _llama3),
    ("<|im_start|>", _chatml),
    ("<start_of_turn>", _gemma),
    ("[INST]", _llama2),
    ("<|user|>", _zephyr),
]


def pick_template(chat_template: str | None, arch: str = ""):
    """Template renderer from GGUF chat_template content / arch heuristic."""
    if chat_template:
        for marker, fn in _FINGERPRINTS:
            if marker in chat_template:
                return fn
    arch = (arch or "").lower()
    if "gemma" in arch:
        return _gemma
    if "qwen" in arch:
        return _chatml
    if "llama" in arch:
        return _llama3
    return _chatml


def get_template_src(ctx) -> str | None:
    if ctx.tok is not None and getattr(ctx.tok, "chat_template", None):
        return ctx.tok.chat_template
    return ctx.cfg.raw_kv.get("tokenizer.chat_template")


def apply_chat_template(ctx, messages: list[dict], tools=None) -> str:
    msgs = [{"role": str(m.get("role", "user")), "content": _content_str(m)}
            for m in messages]
    tmpl_src = get_template_src(ctx)
    if tmpl_src:
        # execute the model's own template with the bundled Jinja subset
        # (common/jinja analogue); fall back to fingerprints on failure
        try:
            from .jinja import render_chat_template

            v = getattr(ctx.tok, "vocab", None)
            bos = (v.tokens[v.bos_id] if v is not None and v.bos_id is not None
                   else "")
            eos = (v.tokens[v.eos_id] if v is not None and v.eos_id is not None
                   else "")
            return render_chat_template(tmpl_src, msgs, bos_token=bos,
                                        eos_token=eos, tools=tools)
        except Exception:
            pass
    fn = pick_template(tmpl_src, ctx.cfg.arch)
    return fn(msgs)


def _content_str(m: dict) -> str:
    c = m.get("content", "")
    if isinstance(c, list):  # OpenAI content-parts form
        out = []
        for p in c:
            if not isinstance(p, dict):
                continue
            if (p.get("type") in ("image_url", "input_image",
                                  "input_audio", "audio_url")
                    or "image_url" in p or "input_audio" in p):
                raise NotImplementedError(
                    f"multimodal content ({p.get('type') or 'media'} parts): not ported "
                    "to tpullm_torch yet")
            out.append(p.get("text", ""))
        return "".join(out)
    return str(c)
