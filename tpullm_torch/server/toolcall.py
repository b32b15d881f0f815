"""Tool-call (function calling) prompt injection + output parsing.

The port's copy of tpullm/server/toolcall.py. Counterpart of the
reference's chat-format machinery (common/chat.cpp COMMON_CHAT_FORMAT_*):
detect the model's native tool-call syntax from its chat template,
describe the tools to the model (natively via the template's ``tools``
variable, or through a generic system-prompt wrapper), and parse tool
invocations out of the generated text into OpenAI ``tool_calls``.
"""
from __future__ import annotations

import json
import re
import uuid


def detect_format(template_src: str | None) -> str:
    """Chat-template fingerprints -> native tool-call syntax family
    (common_chat_format_detect analogue)."""
    t = template_src or ""
    if "<tool_call>" in t:
        return "hermes"  # Qwen2.5 / Hermes-2/3: <tool_call>{json}</tool_call>
    if "[TOOL_CALLS]" in t:
        return "mistral"  # Mistral Nemo: [TOOL_CALLS][{...}, ...]
    if "<|python_tag|>" in t or "ipython" in t:
        return "llama3"  # Llama-3.x: bare {"name": ..., "parameters": ...}
    if "<tool▁calls▁begin>" in t or "<｜tool▁calls▁begin｜>" in t:
        return "deepseek"
    return "generic"


def tools_system_prompt(tools: list[dict]) -> str:
    """Generic wrapper (common/chat.cpp generic handler): describe the tools
    and pin the reply syntax so any instruct model can be driven."""
    specs = []
    for t in tools:
        fn = t.get("function", t)
        specs.append({"name": fn.get("name", ""),
                      "description": fn.get("description", ""),
                      "parameters": fn.get("parameters", {})})
    return (
        "You have access to the following tools:\n"
        + json.dumps(specs, indent=2)
        + "\n\nTo call a tool, respond ONLY with a JSON object of the form\n"
        '{"tool_calls": [{"name": <function-name>, "arguments": {...}}]}\n'
        "Otherwise answer normally."
    )


def inject_tools(messages: list[dict], tools: list[dict], fmt: str) -> list[dict]:
    """Add the generic tool system prompt when the template has no native
    ``tools`` support. Native formats render tools themselves."""
    if fmt != "generic":
        return messages
    sysmsg = {"role": "system", "content": tools_system_prompt(tools)}
    if messages and messages[0].get("role") == "system":
        head = dict(messages[0])
        head["content"] = f"{head.get('content', '')}\n\n{sysmsg['content']}"
        return [head] + list(messages[1:])
    return [sysmsg] + list(messages)


def _mk_call(name: str, arguments) -> dict:
    if not isinstance(arguments, str):
        arguments = json.dumps(arguments)
    return {
        "id": "call_" + uuid.uuid4().hex[:12],
        "type": "function",
        "function": {"name": str(name), "arguments": arguments},
    }


def _try_json(s: str):
    try:
        return json.loads(s)
    except (json.JSONDecodeError, TypeError):
        return None


_HERMES_RE = re.compile(r"<tool_call>\s*(.*?)\s*</tool_call>", re.DOTALL)
_FENCE_RE = re.compile(r"```(?:json)?\s*(.*?)\s*```", re.DOTALL)


def parse_tool_calls(text: str, fmt: str):
    """-> (content_without_calls: str, calls: list[openai tool_call]).

    Mirrors common_chat_parse: each family's syntax is extracted; whatever
    is not a call stays as assistant content."""
    calls: list[dict] = []

    if fmt == "hermes":
        def repl(m):
            obj = _try_json(m.group(1))
            if isinstance(obj, dict) and "name" in obj:
                calls.append(_mk_call(obj["name"],
                                      obj.get("arguments", obj.get("parameters", {}))))
                return ""
            return m.group(0)
        content = _HERMES_RE.sub(repl, text)
        return content.strip(), calls

    if fmt == "mistral":
        i = text.find("[TOOL_CALLS]")
        if i >= 0:
            payload = _try_json(text[i + len("[TOOL_CALLS]"):].strip())
            if isinstance(payload, list):
                for c in payload:
                    if isinstance(c, dict) and "name" in c:
                        calls.append(_mk_call(c["name"], c.get("arguments", {})))
                return text[:i].strip(), calls
        return text.strip(), calls

    if fmt in ("llama3", "deepseek", "generic"):
        stripped = text.strip()
        for candidate in [stripped] + _FENCE_RE.findall(stripped):
            obj = _try_json(candidate.strip())
            if isinstance(obj, dict):
                if "tool_calls" in obj and isinstance(obj["tool_calls"], list):
                    for c in obj["tool_calls"]:
                        if isinstance(c, dict) and "name" in c:
                            calls.append(_mk_call(
                                c["name"], c.get("arguments",
                                                 c.get("parameters", {}))))
                    return str(obj.get("response", "") or ""), calls
                if "name" in obj and ("parameters" in obj or "arguments" in obj):
                    calls.append(_mk_call(
                        obj["name"], obj.get("parameters",
                                             obj.get("arguments", {}))))
                    return "", calls
        return stripped, calls

    return text.strip(), calls
