"""The port's chat path against the JAX package's on the CPU: the Jinja
interpreter on chat templates, apply_chat_template and the tool-call
helpers, and a port ServerContext against a JAX one with the same
tokenizer on the same synth weights (text and chat tasks, f32, greedy, a
stop string and a forced end of generation); then the port's HTTP front
end with a tokenizer, driven with urllib. Inputs come from numpy seeds;
every comparison is exact equality."""
import json
import socket
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpullm.gguf.constants import GGMLType
from tpullm.gguf.writer import GGUFWriter
from tpullm.runtime.loader import load_model as jload
from tpullm.server import chat as jchat
from tpullm.server import jinja as jjinja
from tpullm.server import toolcall as jtool
from tpullm.server.context import GenParams as JGenParams
from tpullm.server.context import ServerContext as JServerContext
from tpullm.tokenizer import Tokenizer as JTokenizer
from tpullm.utils.synth import build_llama_gguf
from tpullm_torch.runtime.loader import load_model
from tpullm_torch.server import chat, jinja, toolcall
from tpullm_torch.server.context import GenParams, ServerContext
from tpullm_torch.server.http import serve
from tpullm_torch.tokenizer import Tokenizer
from tpullm_torch.utils.synth import LLAMA3_CHAT_TEMPLATE, synth_bpe_vocab

torch.set_num_threads(2)

MSGS = [
    {"role": "system", "content": "be brief"},
    {"role": "user", "content": "hi"},
    {"role": "assistant", "content": "hello"},
    {"role": "user", "content": "bye?"},
]

# the chat templates of tests/test_jinja.py and Llama-3's
LLAMA3_TMPL = (
    "{{ bos_token }}{% for message in messages %}"
    "{{ '<|start_header_id|>' + message['role'] + '<|end_header_id|>\\n\\n' "
    "+ message['content'] | trim + '<|eot_id|>' }}{% endfor %}"
    "{% if add_generation_prompt %}"
    "{{ '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}{% endif %}"
)
CHATML_TMPL = (
    "{% for message in messages %}{{'<|im_start|>' + message['role'] + '\\n'"
    " + message['content'] + '<|im_end|>' + '\\n'}}{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|im_start|>assistant\\n' }}{% endif %}"
)
MISTRAL_TMPL = (
    "{{ bos_token }}{% for message in messages %}"
    "{% if message['role'] == 'user' %}{{ '[INST] ' + message['content'] + ' [/INST]' }}"
    "{% elif message['role'] == 'assistant' %}{{ message['content'] + eos_token }}"
    "{% endif %}{% endfor %}"
)
RAISING_TMPL = "{% if messages[0]['role'] != 'user' %}{{ raise_exception('bad') }}{% endif %}ok"
TEMPLATES = [LLAMA3_TMPL, CHATML_TMPL, MISTRAL_TMPL, LLAMA3_CHAT_TEMPLATE]

EXPRESSIONS = [
    ("{{ 1 + 2 }}", {}), ("{{ 'a' ~ 'b' ~ 1 }}", {}), ("{{ x if y else 'z' }}",
                                                      {"x": "v", "y": False}),
    ("{{ items | length }}", {"items": [1, 2, 3]}), ("{{ s | trim | upper }}", {"s": "  hi "}),
    ("{{ d['k'] }}{{ d.k }}", {"d": {"k": "v"}}), ("{{ s.strip().startswith('h') }}",
                                                    {"s": " hi"}),
    ("{% set n = 0 %}{% for x in xs %}{% if x % 2 == 0 %}{{ x }},{% endif %}{% endfor %}",
     {"xs": [1, 2, 3, 4]}),
    ("{% for m in ms %}{{ loop.index }}:{{ m.role }}{% if not loop.last %};{% endif %}"
     "{% endfor %}", {"ms": MSGS[:2]}),
    ("a\n  {%- if true %}x{% endif -%}\n  b", {}),
    ("{% set ns = namespace(n=0) %}{% for x in xs %}{% set ns.n = ns.n + x %}{% endfor %}"
     "{{ ns.n }}", {"xs": [1, 2, 3]}),
    ("{{ nothing }}|{{ nothing is defined }}", {}), ("{{ x | default('d') }}", {}),
    ("{{ d | tojson }}", {"d": {"a": 1, "b": [True, None]}}),
    ("{{ xs | join(', ') }} {{ xs | first }} {{ xs | last }}", {"xs": ["p", "q", "r"]}),
    ("{% for k, v in d.items() %}{{ k }}={{ v }};{% endfor %}", {"d": {"a": 1, "b": 2}}),
]


@pytest.mark.parametrize("src,env", EXPRESSIONS)
def test_jinja_render_matches_jax(src, env):
    assert jinja.Template(src).render(**env) == jjinja.Template(src).render(**env)


@pytest.mark.parametrize("tmpl", TEMPLATES)
@pytest.mark.parametrize("n_msgs", [1, 2, 4])
def test_render_chat_template_matches_jax(tmpl, n_msgs):
    msgs = MSGS[-n_msgs:]
    kw = dict(bos_token="<|begin_of_text|>", eos_token="</s>")
    out = jinja.render_chat_template(tmpl, msgs, **kw)
    assert out == jjinja.render_chat_template(tmpl, msgs, **kw)
    assert msgs[-1]["content"] in out


def test_render_raises_like_jax():
    with pytest.raises(jinja.TemplateError):
        jinja.render_chat_template(RAISING_TMPL, MSGS)
    with pytest.raises(jjinja.TemplateError):
        jjinja.render_chat_template(RAISING_TMPL, MSGS)
    assert jinja.render_chat_template(RAISING_TMPL, MSGS[1:]) == "ok"


def test_llama3_template_renders_the_published_layout():
    out = jinja.render_chat_template(LLAMA3_CHAT_TEMPLATE, MSGS[:2],
                                     bos_token="<|begin_of_text|>")
    assert out == ("<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\nbe brief"
                   "<|eot_id|><|start_header_id|>user<|end_header_id|>\n\nhi<|eot_id|>"
                   "<|start_header_id|>assistant<|end_header_id|>\n\n")


def write_vocab_gguf(path: str, vocab) -> str:
    """A byte-level BPE vocab with its specials and chat template, written
    with the JAX package's GGUF writer."""
    w = GGUFWriter(path, arch="llama")
    w.add_string("tokenizer.ggml.model", vocab.model)
    w.add_string("tokenizer.ggml.pre", vocab.pre)
    w.add_array("tokenizer.ggml.tokens", vocab.tokens)
    w.add_array("tokenizer.ggml.token_type",
                np.asarray([3 if a & 8 else 1 for a in vocab.attrs], np.int32))
    w.add_array("tokenizer.ggml.merges", vocab.merges)
    for key, val in (("bos", vocab.bos_id), ("eos", vocab.eos_id), ("eot", vocab.eot_id)):
        w.add_uint32(f"tokenizer.ggml.{key}_token_id", val)
    w.add_bool("tokenizer.ggml.add_bos_token", True)
    w.add_string("tokenizer.chat_template", vocab.chat_template)
    w.write()
    return path


@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
    return write_vocab_gguf(str(tmp_path_factory.mktemp("vocab") / "bpe.gguf"),
                            synth_bpe_vocab(1024, seed=2))


def _ctxs(path, template, arch="llama"):
    """A port and a JAX stand-in for a ServerContext: what the chat helpers
    read (the tokenizer, the GGUF's template, the arch)."""
    raw = {"tokenizer.chat_template": template} if template else {}
    jt = JTokenizer.from_gguf(path)
    tt = Tokenizer.from_gguf(path)
    tt.vocab.chat_template = template
    return (SimpleNamespace(tok=tt, cfg=SimpleNamespace(raw_kv=raw, arch=arch)),
            SimpleNamespace(tok=jt, cfg=SimpleNamespace(raw_kv=raw, arch=arch)))


@pytest.mark.parametrize("template,arch", [
    (LLAMA3_CHAT_TEMPLATE, "llama"), (CHATML_TMPL, "llama"), (MISTRAL_TMPL, "llama"),
    (None, "llama"), (None, "qwen2"), (None, "gemma3"), ("<|user|> {% bad", "llama"),
    ("[INST] {{ undefined_fn() }}", "llama")])
def test_apply_chat_template_matches_jax(vocab_path, template, arch):
    tctx, jctx = _ctxs(vocab_path, template, arch)
    assert chat.get_template_src(tctx) == jchat.get_template_src(jctx)
    parts = [{"role": "user", "content": [{"type": "text", "text": "a "},
                                          {"type": "text", "text": "b"}]}]
    for msgs in (MSGS, MSGS[1:], parts):
        assert chat.apply_chat_template(tctx, msgs) == jchat.apply_chat_template(jctx, msgs)
    fn = chat.pick_template(template, arch)
    assert fn.__name__ == jchat.pick_template(template, arch).__name__


def test_media_part_raises_not_ported(vocab_path):
    tctx, _ = _ctxs(vocab_path, LLAMA3_CHAT_TEMPLATE)
    msgs = [{"role": "user", "content": [
        {"type": "text", "text": "what is this?"},
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,AAAA"}}]}]
    with pytest.raises(NotImplementedError, match="multimodal"):
        chat.apply_chat_template(tctx, msgs)


TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Get the weather",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}},
                   "required": ["city"]}}}]
TOOL_TEXTS = [
    ('thinking...\n<tool_call>\n{"name": "get_weather", "arguments": {"city": "Paris"}}\n'
     '</tool_call><tool_call>{"name": "b", "arguments": {}}</tool_call>', "hermes"),
    ("<tool_call>oops</tool_call>", "hermes"),
    ('[TOOL_CALLS][{"name": "get_weather", "arguments": {"city": "NYC"}}]', "mistral"),
    ("no calls here", "mistral"),
    ('{"name": "get_weather", "parameters": {"city": "SF"}}', "llama3"),
    ('{"tool_calls": [{"name": "a", "arguments": {"x": 1}}], "response": "done"}', "generic"),
    ('Sure!\n```json\n{"tool_calls": [{"name": "a", "arguments": {}}]}\n```', "generic"),
    ("just an answer", "generic"), ('{"name": "x", "arguments": "raw"}', "deepseek"),
]


def _no_ids(calls):
    return [{k: v for k, v in c.items() if k != "id"} for c in calls]


@pytest.mark.parametrize("text,fmt", TOOL_TEXTS)
def test_parse_tool_calls_matches_jax(text, fmt):
    content, calls = toolcall.parse_tool_calls(text, fmt)
    jcontent, jcalls = jtool.parse_tool_calls(text, fmt)
    assert content == jcontent and _no_ids(calls) == _no_ids(jcalls)
    assert all(c["id"].startswith("call_") for c in calls)


def test_tool_helpers_match_jax():
    for src in ("{% if tools %}<tool_call>{% endif %}", "... [TOOL_CALLS] ...",
                "<|python_tag|> stuff", "{{ messages }}", None, LLAMA3_CHAT_TEMPLATE,
                "<｜tool▁calls▁begin｜>"):
        assert toolcall.detect_format(src) == jtool.detect_format(src)
    for msgs in (MSGS[1:2], MSGS):
        for fmt in ("generic", "hermes"):
            assert toolcall.inject_tools(msgs, TOOLS, fmt) == jtool.inject_tools(msgs, TOOLS,
                                                                                 fmt)
    assert toolcall.tools_system_prompt(TOOLS) == jtool.tools_system_prompt(TOOLS)


# ------------------------------------------------------- the serving loop


@pytest.fixture(scope="module")
def tiny_bpe(tmp_path_factory, vocab_path):
    """A 2-layer synth Llama of the vocab's 1024 ids, both packages' weights
    and tokenizers read from the same files."""
    path = str(tmp_path_factory.mktemp("chat_model") / "tiny.gguf")
    build_llama_gguf(path, vocab_size=1024, n_embd=512, n_layer=2, n_head=4, n_head_kv=2,
                     n_ff=512, qtype=GGMLType.Q4_K, seed=7)
    jcfg, jparams, _ = jload(path)
    cfg, params, _ = load_model(path, device="cpu")
    return (jcfg, jparams, JTokenizer.from_gguf(vocab_path), cfg, params,
            Tokenizer.from_gguf(vocab_path))


def _prompts(tok, ctx):
    """A text prompt and a chat prompt, as token ids."""
    text = tok.encode("The quick brown fox jumps over the lazy dog.", add_special=True,
                      parse_special=True)
    msgs = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hello"}]
    rendered = (chat if isinstance(tok, Tokenizer) else jchat).apply_chat_template(ctx, msgs)
    return [text, tok.encode(rendered, add_special=True, parse_special=True)]


def _serve(ctx, gp_cls, prompts, eog):
    """Each prompt greedy (12 tokens); then with a stop string, two
    characters from the middle of that text; then with the end-of-turn
    token biased to the top -> [(tokens, text, reason)]."""
    out = []
    ctx.start()
    try:
        for p in prompts:
            r = ctx.generate(list(p), gp_cls(max_tokens=12, temperature=0.0))
            out.append((r["tokens"], r["text"], r["reason"]))
            mid = len(r["text"]) // 2
            for kw in ({"stop": [r["text"][mid: mid + 2]]}, {"logit_bias": {eog: 100.0}}):
                r = ctx.generate(list(p), gp_cls(max_tokens=12, temperature=0.0, **kw))
                out.append((r["tokens"], r["text"], r["reason"]))
    finally:
        ctx.stop()
    return out


@pytest.mark.parametrize("kv", ["f32", "q8"])
def test_server_context_with_tokenizer_matches_jax(tiny_bpe, kv):
    """Same prompt ids, generated ids, text and finish reasons from the
    port's and the JAX package's ServerContext with the same tokenizer."""
    jcfg, jparams, jtok, cfg, params, ttok = tiny_bpe
    common = dict(n_slots=2, max_seq_len=128, decode_chunk=4, prefill_chunk=16)
    jctx = JServerContext(jcfg, jparams, jtok, compute_dtype=jnp.float32,
                          kv_dtype={"f32": jnp.float32, "q8": "q8"}[kv], **common)
    tctx = ServerContext(cfg, params, ttok, compute_dtype=torch.float32,
                         kv_dtype={"f32": torch.float32, "q8": "q8"}[kv], device="cpu",
                         **common)
    prompts = _prompts(ttok, tctx)
    assert prompts == _prompts(jtok, jctx)
    got = _serve(tctx, GenParams, prompts, ttok.vocab.eot_id)
    want = _serve(jctx, JGenParams, prompts, ttok.vocab.eot_id)
    assert got == want
    for (toks, text, reason), (_, cut, why) in zip(got[0::3], got[1::3]):
        assert reason == "length" and len(toks) == 12 and len(text) >= 4
        assert why == "stop" and len(cut) < len(text) and text.startswith(cut)
    for toks, text, reason in got[2::3]:
        assert (toks, text, reason) == ([], "", "stop")


# --------------------------------------------------------------- the HTTP front end


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def http_chat(tiny_bpe):
    *_, cfg, params, tok = tiny_bpe
    ctx = ServerContext(cfg, params, tok, n_slots=2, max_seq_len=1024, decode_chunk=4,
                        prefill_chunk=32, compute_dtype=torch.float32, kv_dtype="q8",
                        model_name="tiny-bpe", device="cpu")
    srv = serve(ctx, "127.0.0.1", _free_port(), block=False)
    yield ctx, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    ctx.stop()


def _post(url, path, body):
    req = urllib.request.Request(url + path, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            raw = r.read().decode()
            code = r.status
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    if body.get("stream"):
        return code, [json.loads(x[6:]) for x in raw.splitlines()
                      if x.startswith("data: ") and x != "data: [DONE]"]
    return code, json.loads(raw)


def _visible(tok, ids, stop=()):
    """The text the server returns for generated ids: the decode without
    special tokens, a trailing partial character held back, cut at the
    first stop string."""
    text = tok.decode(ids, skip_special=True)
    if text.endswith("�"):
        text = text[: text.rfind("�")]
    for s in stop:
        if s in text:
            text = text[: text.find(s)]
    return text


CHAT_MSGS = [{"role": "system", "content": "answer briefly"},
             {"role": "user", "content": "What is the capital of France?"}]


def test_http_chat_plain_and_streamed(http_chat):
    ctx, url = http_chat
    body = {"messages": CHAT_MSGS, "max_tokens": 10, "temperature": 0}
    code, r = _post(url, "/v1/chat/completions", body)
    assert code == 200 and r["object"] == "chat.completion"
    rendered = chat.apply_chat_template(ctx, CHAT_MSGS)
    assert r["usage"]["prompt_tokens"] == len(ctx.tok.encode(rendered, True, True))
    choice = r["choices"][0]
    assert choice["message"]["role"] == "assistant"
    assert choice["message"]["content"] == _visible(ctx.tok, choice["tokens"])
    code, events = _post(url, "/v1/chat/completions", dict(body, stream=True))
    assert code == 200 and all(e["object"] == "chat.completion.chunk" for e in events)
    joined = "".join(e["choices"][0]["delta"].get("content", "") for e in events)
    last = events[-1]["choices"][0]
    assert joined == _visible(ctx.tok, last["tokens"]) == choice["message"]["content"]
    assert last["finish_reason"] == choice["finish_reason"]
    assert events[-1]["timings"]["prompt_tokens"] == r["usage"]["prompt_tokens"]


def test_http_chat_stop_and_forced_end_of_turn(http_chat):
    ctx, url = http_chat
    base = {"messages": CHAT_MSGS, "max_tokens": 10, "temperature": 0}
    _, r = _post(url, "/v1/chat/completions", base)
    text = r["choices"][0]["message"]["content"]
    stop = text[2:4]
    _, s = _post(url, "/v1/chat/completions", dict(base, stop=stop))
    assert s["choices"][0]["finish_reason"] == "stop"
    assert s["choices"][0]["message"]["content"] == _visible(ctx.tok, s["choices"][0]["tokens"],
                                                             [stop])
    eot = ctx.tok.vocab.eot_id
    code, e = _post(url, "/v1/chat/completions", dict(base, logit_bias={str(eot): 100}))
    assert code == 200 and e["choices"][0]["finish_reason"] == "stop"
    assert e["choices"][0]["message"]["content"] == "" and e["usage"]["completion_tokens"] == 0


def test_http_chat_with_tools(http_chat, monkeypatch):
    """The tools go into the prompt (Llama-3's template has no native tool
    syntax: the generic system prompt); a reply that is a call comes back
    as tool_calls with finish_reason "tool_calls"."""
    ctx, url = http_chat
    body = {"messages": CHAT_MSGS[1:], "tools": TOOLS, "max_tokens": 6, "temperature": 0}
    code, r = _post(url, "/v1/chat/completions", body)
    fmt = toolcall.detect_format(chat.get_template_src(ctx))
    prompt = chat.apply_chat_template(ctx, toolcall.inject_tools(CHAT_MSGS[1:], TOOLS, fmt),
                                      tools=TOOLS)
    assert code == 200 and fmt == "generic" and "get_weather" in prompt
    assert r["usage"]["prompt_tokens"] == len(ctx.tok.encode(prompt, True, True))
    code, none = _post(url, "/v1/chat/completions", dict(body, tool_choice="none"))
    assert code == 200 and none["usage"]["prompt_tokens"] < r["usage"]["prompt_tokens"]

    call = '{"tool_calls": [{"name": "get_weather", "arguments": {"city": "Paris"}}]}'

    def answer(task):
        task.out.put(("done", {"reason": "stop", "text": call, "tokens": [5, 6],
                               "stats": {"prompt_tokens": len(task.tokens),
                                         "completion_tokens": 2}}))
        return task

    monkeypatch.setattr(ctx, "submit", answer)
    code, r = _post(url, "/v1/chat/completions", body)
    msg = r["choices"][0]["message"]
    assert code == 200 and r["choices"][0]["finish_reason"] == "tool_calls"
    assert msg["content"] is None and msg["tool_calls"][0]["function"]["name"] == "get_weather"
    assert json.loads(msg["tool_calls"][0]["function"]["arguments"]) == {"city": "Paris"}


def test_http_string_prompt_and_logprobs(http_chat):
    ctx, url = http_chat
    prompt = "<|begin_of_text|>Once upon a time"
    code, r = _post(url, "/v1/completions", {"prompt": prompt, "max_tokens": 5,
                                            "temperature": 0, "n_probs": 2})
    assert code == 200
    assert r["usage"]["prompt_tokens"] == len(ctx.tok.encode(prompt, True, True)) == 2 + len(
        ctx.tok.encode("Once upon a time", False))
    choice = r["choices"][0]
    assert choice["text"] == _visible(ctx.tok, choice["tokens"])
    lp = choice["logprobs"]
    assert lp["tokens"] == [ctx.tok.decode([t]) for t in choice["tokens"]]
    assert all(len(t) <= 2 and all(isinstance(k, str) for k in t) for t in lp["top_logprobs"])
    _, literal = _post(url, "/completion", {"prompt": prompt, "max_tokens": 1,
                                            "parse_special": False})
    assert literal["usage"]["prompt_tokens"] == len(ctx.tok.encode(prompt, True, False))
    code, err = _post(url, "/completion", {"prompt": {"text": "x"}})
    assert code == 400


def test_http_tokenize_detokenize_apply_template(http_chat):
    ctx, url = http_chat
    text = "Hello there, tokenizer! <|eot_id|> 123"
    code, r = _post(url, "/tokenize", {"content": text})
    assert code == 200 and r["tokens"] == ctx.tok.encode(text, add_special=False)
    _, with_bos = _post(url, "/tokenize", {"content": text, "add_special": True})
    assert with_bos["tokens"] == [ctx.tok.vocab.bos_id] + r["tokens"]
    code, d = _post(url, "/detokenize", {"tokens": r["tokens"]})
    assert code == 200 and d["content"] == text
    code, _ = _post(url, "/detokenize", {"tokens": [10 ** 6]})
    assert code == 400
    code, t = _post(url, "/apply-template", {"messages": CHAT_MSGS})
    assert code == 200 and t["prompt"] == chat.apply_chat_template(ctx, CHAT_MSGS)
    assert t["prompt"].endswith("<|start_header_id|>assistant<|end_header_id|>\n\n")


@pytest.mark.parametrize("path,body,what", [
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,AAAA"}}]}]},
     "multimodal"),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": [
        {"type": "input_audio", "input_audio": {"data": "AAAA", "format": "wav"}}]}]},
     "multimodal"),
    ("/apply-template", {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "data:,"}}]}]}, "multimodal"),
    ("/v1/messages", {"messages": CHAT_MSGS[1:]}, "Anthropic"),
    ("/v1/responses", {"input": "x"}, "Responses"),
    ("/v1/embeddings", {"input": "x"}, "embeddings"),
    ("/infill", {"input_prefix": "a"}, "infill")])
def test_http_with_tokenizer_still_refuses(http_chat, path, body, what):
    _, url = http_chat
    code, r = _post(url, path, body)
    assert code == 501 and what in r["error"]["message"], r
