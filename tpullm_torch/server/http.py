"""HTTP surface of the port's serving engine.

Counterpart of tpullm/server/http.py over the port's own ServerContext: a
stdlib ThreadingHTTPServer whose request threads parse and validate, post a
Task to the single inference loop, and answer with JSON or stream SSE
chunks. Served:

  POST /completion /completions /v1/completions   text or token-array
                                                  prompts, plain or SSE
  POST /v1/chat/completions                       chat (the model's
                                                  template), plain or SSE,
                                                  with tools
  POST /tokenize /detokenize /apply-template
  GET  /health /v1/models /props /metrics (Prometheus text) /slots

Text, chat and the tokenizer endpoints need the context's tokenizer: a
server started without one answers them 501. Every other endpoint of the
JAX server (embeddings, rerank, infill, slot and state actions, LoRA, the
Anthropic and Responses APIs, the web UI), media content parts and a
grammar, JSON-schema or infill-sampler request answer 501 naming what is
missing.
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .chat import apply_chat_template, get_template_src
from .context import GenParams, ServerContext, Task
from .toolcall import detect_format, inject_tools, parse_tool_calls

COMPLETION_PATHS = ("/completion", "/completions", "/v1/completions")
# what needs the context's tokenizer, by path
TOKENIZER_PATHS = {"/v1/chat/completions": "chat completions", "/tokenize": "/tokenize",
                   "/detokenize": "/detokenize", "/apply-template": "/apply-template"}
# endpoints of the JAX server that the port does not serve yet
NOT_PORTED = {
    "/": "the web UI", "/index.html": "the web UI", "/lora-adapters": "LoRA adapters",
    "/v1/messages": "the Anthropic Messages API",
    "/v1/messages/count_tokens": "the Anthropic Messages API",
    "/v1/responses": "the Responses API",
    "/embedding": "embeddings", "/embeddings": "embeddings", "/v1/embeddings": "embeddings",
    "/rerank": "reranking", "/reranking": "reranking", "/v1/rerank": "reranking",
    "/v1/reranking": "reranking", "/infill": "infill (FIM prompts)",
    "/state": "state save/restore",
}


def _gen_params(body: dict) -> GenParams:
    p = GenParams()
    m = {
        "max_tokens": "max_tokens", "n_predict": "max_tokens",
        "temperature": "temperature", "top_k": "top_k", "top_p": "top_p",
        "min_p": "min_p", "typical_p": "typical_p", "top_n_sigma": "top_n_sigma",
        "xtc_probability": "xtc_probability", "xtc_threshold": "xtc_threshold",
        "repeat_penalty": "penalty_repeat", "frequency_penalty": "penalty_freq",
        "presence_penalty": "penalty_present", "seed": "seed",
        "ignore_eos": "ignore_eos", "stream": "stream", "n_probs": "n_probs",
        "mirostat": "mirostat", "mirostat_tau": "mirostat_tau",
        "mirostat_eta": "mirostat_eta", "n_keep": "n_keep",
        "top_logprobs": "n_probs",
        "dry_multiplier": "dry_multiplier", "dry_base": "dry_base",
        "dry_allowed_length": "dry_allowed_length",
    }
    for k, attr in m.items():
        if k in body and body[k] is not None:
            setattr(p, attr, type(getattr(p, attr))(body[k]))
    if body.get("logprobs") is True and p.n_probs == 0:
        p.n_probs = 1
    stop = body.get("stop")
    if isinstance(stop, str):
        p.stop = [stop]
    elif isinstance(stop, list):
        p.stop = [str(s) for s in stop]
    lb = body.get("logit_bias")
    if isinstance(lb, (dict, list)) and lb:
        p.logit_bias = lb
    # refused with 501 by the handler (GenParams.unported)
    if body.get("grammar"):
        p.grammar = str(body["grammar"])
    if body.get("grammar_lazy"):
        p.grammar_lazy = True
    if isinstance(body.get("grammar_triggers"), list) and body["grammar_triggers"]:
        p.grammar_triggers = tuple(str(t) for t in body["grammar_triggers"])
    samplers = body.get("samplers")
    if (isinstance(samplers, list) and "infill" in samplers) or body.get("infill_sampler"):
        p.infill_sampler = True
    if body.get("json_schema"):
        p.json_schema = body["json_schema"]
    rf = body.get("response_format")
    if isinstance(rf, dict):
        if rf.get("type") == "json_schema":
            js = rf.get("json_schema", {})
            p.json_schema = js.get("schema", js)
        elif rf.get("type") == "json_object":
            p.json_schema = {}
    return p


class Handler(BaseHTTPRequestHandler):
    ctx: ServerContext = None  # set by serve()
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _json(self, code: int, obj):
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _error(self, code: int, msg: str, kind: str = "invalid_request_error"):
        self._json(code, {"error": {"message": msg, "type": kind}})

    def _not_ported(self, what: str):
        self._error(501, f"{what}: not ported to tpullm_torch yet", "not_implemented_error")

    def _no_tokenizer(self, what: str):
        self._error(501, f"{what} need a tokenizer, and this server has none (start it "
                    "from a GGUF that holds a vocab)", "not_implemented_error")

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(n)) if n else {}

    def _sse_start(self):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

    def _sse(self, obj):
        data = b"data: " + json.dumps(obj).encode() + b"\n\n"
        self.wfile.write(hex(len(data))[2:].encode() + b"\r\n" + data + b"\r\n")

    def _sse_done(self):
        data = b"data: [DONE]\n\n"
        self.wfile.write(hex(len(data))[2:].encode() + b"\r\n" + data + b"\r\n")
        self.wfile.write(b"0\r\n\r\n")

    def do_GET(self):
        ctx = self.ctx
        path = self.path.split("?")[0]
        if path == "/health":
            self._json(200, {"status": "ok"})
        elif path == "/v1/models":
            self._json(200, {"object": "list", "data": [{
                "id": ctx.model_name, "object": "model", "created": 0,
                "owned_by": "tpullm"}]})
        elif path == "/props":
            self._json(200, {"model": ctx.model_name, "n_ctx": ctx.max_seq_len,
                             "n_slots": ctx.n_slots, "arch": ctx.cfg.arch,
                             "vocab_size": ctx.cfg.vocab_size})
        elif path == "/slots":
            self._json(200, [{"id": i, "busy": r.task is not None,
                              "n_past": ctx.memory.slots[i].n_past, "n_gen": len(r.gen)}
                             for i, r in enumerate(ctx.rt)])
        elif path == "/metrics":
            lines = []
            for k, v in ctx.metrics.items():
                name = f"tpullm:{k}"
                lines.append(f"# TYPE {name} {'counter' if k.endswith('_total') else 'gauge'}")
                lines.append(f"{name} {v}")
            data = ("\n".join(lines) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        elif path in NOT_PORTED:
            self._not_ported(NOT_PORTED[path])
        else:
            self._error(404, f"unknown path {path}")

    def do_POST(self):
        ctx = self.ctx
        path = self.path.split("?")[0]
        try:
            body = self._body()
        except Exception as e:
            return self._error(400, f"bad json: {e}")
        try:
            if path in COMPLETION_PATHS:
                return self._completion(body, chat=False)
            if path.startswith("/slots/"):
                return self._not_ported("slot save/restore/erase")
            if path in NOT_PORTED:
                return self._not_ported(NOT_PORTED[path])
            if path not in TOKENIZER_PATHS:
                return self._error(404, f"unknown path {path}")
            if ctx.tok is None:
                return self._no_tokenizer(TOKENIZER_PATHS[path])
            if path == "/v1/chat/completions":
                return self._completion(body, chat=True)
            if path == "/tokenize":
                toks = ctx.tok.encode(str(body.get("content", "")),
                                      add_special=bool(body.get("add_special", False)))
                return self._json(200, {"tokens": toks})
            if path == "/detokenize":
                toks = self._token_ids(body.get("tokens", []))
                if toks is not None:
                    self._json(200, {"content": ctx.tok.decode(toks)})
                return
            prompt = apply_chat_template(ctx, body.get("messages", []))
            return self._json(200, {"prompt": prompt})
        except BrokenPipeError:
            pass
        except NotImplementedError as e:  # a media part, a family's tokenizer
            self._error(501, str(e), "not_implemented_error")
        except Exception as e:  # surface handler faults as 500s, keep serving
            try:
                self._error(500, f"{type(e).__name__}: {e}")
            except Exception:
                pass

    def _token_ids(self, ids) -> "list[int] | None":
        """A token-id array within the vocabulary, else answer 400 -> None."""
        V = self.ctx.cfg.vocab_size
        if not (isinstance(ids, list) and all(isinstance(t, int) and not isinstance(t, bool)
                                              and 0 <= t < V for t in ids)):
            self._error(400, f"tokens must be an array of ids in [0, {V})")
            return None
        return ids

    def _prompt_tokens(self, body: dict, chat: bool):
        """The request's prompt as token ids -> (ids, tool-call format or
        None); None in place of ids where the answer was already sent."""
        ctx = self.ctx
        if chat:
            msgs = body.get("messages", [])
            tools = body.get("tools")
            tool_fmt = None
            if tools and body.get("tool_choice") != "none":
                tool_fmt = detect_format(get_template_src(ctx))
                msgs = inject_tools(msgs, tools, tool_fmt)
                text = apply_chat_template(ctx, msgs, tools=tools)
            else:
                text = apply_chat_template(ctx, msgs)
            return ctx.tok.encode(text, add_special=True, parse_special=True), tool_fmt
        prompt = body.get("prompt", "")
        if isinstance(prompt, list) and prompt:
            return self._token_ids(prompt), None
        if not isinstance(prompt, str):
            self._error(400, "prompt must be a string or an array of token ids")
            return None, None
        if ctx.tok is None:
            self._no_tokenizer("text prompts")
            return None, None
        return ctx.tok.encode(prompt, add_special=True,
                              parse_special=bool(body.get("parse_special", True))), None

    def _completion(self, body: dict, chat: bool):
        ctx = self.ctx
        params = _gen_params(body)
        refused = params.unported()
        if refused:
            return self._not_ported(refused)
        tokens, tool_fmt = self._prompt_tokens(body, chat)
        if tokens is None:
            return
        created = int(time.time())
        rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:16]
        task = Task(tokens=tokens, params=params)
        ctx.submit(task)
        model = body.get("model") or ctx.model_name

        if params.stream:
            self._sse_start()
            try:
                for kind, payload in task.events():
                    if kind == "error":
                        self._sse({"error": payload})
                        break
                    if kind == "delta":
                        self._sse(_chunk(rid, created, model, payload["text"], None, chat))
                    elif kind == "done":
                        self._sse(_chunk(rid, created, model, "", payload["reason"], chat,
                                         payload["stats"], payload["tokens"]))
                self._sse_done()
            except BrokenPipeError:
                task.cancelled.set()
            return

        result = None
        for kind, payload in task.events():
            if kind == "error":
                return self._error(400, str(payload))
            if kind == "done":
                result = payload
        stats = result["stats"]
        usage = {"prompt_tokens": stats["prompt_tokens"],
                 "completion_tokens": stats["completion_tokens"],
                 "total_tokens": stats["prompt_tokens"] + stats["completion_tokens"]}
        if chat:
            message = {"role": "assistant", "content": result["text"]}
            finish = result["reason"]
            if tool_fmt is not None:
                content, calls = parse_tool_calls(result["text"], tool_fmt)
                if calls:
                    message = {"role": "assistant", "content": content or None,
                               "tool_calls": calls}
                    finish = "tool_calls"
            return self._json(200, {
                "id": rid, "object": "chat.completion", "created": created,
                "model": model, "usage": usage, "timings": stats,
                "choices": [{"index": 0, "finish_reason": finish, "message": message,
                             "tokens": result["tokens"]}]})
        lp = None
        if result.get("logprobs"):
            tokp = result["logprobs"]
            name = (lambda t: ctx.tok.decode([t])) if ctx.tok else str
            lp = {"tokens": [name(e["token"]) for e in tokp] if ctx.tok else None,
                  "token_logprobs": [e["logprob"] for e in tokp],
                  "top_logprobs": [{name(t): v for t, v in e["top"]} for e in tokp]}
        self._json(200, {
            "id": rid, "object": "text_completion", "created": created,
            "model": model, "usage": usage, "timings": stats,
            "choices": [{"index": 0, "finish_reason": result["reason"],
                         "text": result["text"], "tokens": result["tokens"],
                         "logprobs": lp}],
        })


def _chunk(rid, created, model, text, finish, chat, stats=None, tokens=None):
    """One SSE event; the last (finish set) also carries the timings and
    every generated id."""
    if chat:
        choice = {"index": 0, "delta": {"content": text} if text else {},
                  "finish_reason": finish}
    else:
        choice = {"index": 0, "text": text, "finish_reason": finish}
    if tokens is not None:
        choice["tokens"] = tokens
    obj = {"id": rid, "object": "chat.completion.chunk" if chat else "text_completion",
           "created": created, "model": model, "choices": [choice]}
    if stats:
        obj["timings"] = stats
    return obj


def serve(ctx: ServerContext, host: str = "127.0.0.1", port: int = 8080,
          block: bool = True):
    """Start the inference loop and the HTTP server; returns the server.
    With block=False both run on daemon threads: stop them with
    ``srv.shutdown(); srv.server_close(); ctx.stop()``."""
    handler = type("BoundHandler", (Handler,), {"ctx": ctx})
    srv = ThreadingHTTPServer((host, port), handler)
    srv.daemon_threads = True
    ctx.start()
    if block:
        try:
            srv.serve_forever()
        finally:
            ctx.stop()
    else:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv
