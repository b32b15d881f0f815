"""BPE pre-tokenizer patterns, run on the standard ``re``.

Counterpart of tpullm/tokenizer/pretokenizers.py. ``PRE_REGEX`` is its table
as it stands: the public patterns of each model's tokenizer.json, adapted
(llama-vocab.cpp:283-460), written for the third-party ``regex`` module.
The port runs them on ``re``, which has no ``\\p{...}`` classes and whose
``\\s``, ``\\d`` and ``\\w`` follow an older Unicode (and take U+001C-U+001F
as space). So each pattern is translated once, at first use: every class
(``\\p{L}``, ``\\s``, ``\\d``, the ``\\w`` of ``\\b``...) is spelled out as the
code-point ranges ``regex`` gives it (``unicode_ranges.py``), inside and
outside ``[...]``. A construct the translator does not know raises.
Several patterns apply in turn: each splits the fragments of the one
before.
"""
from __future__ import annotations

import functools
import re

from .unicode_ranges import TABLES

_LLAMA3 = (
    r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])"
    r"|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*"
    r"|\s*[\r\n]+|\s+(?!\S)|\s+"
)
_GPT2 = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)"
_QWEN2 = (
    r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])"
    r"|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*"
    r"|\s*[\r\n]+|\s+(?!\S)|\s+"
)

PRE_REGEX: dict[str, list[str]] = {
    "default": [_GPT2],
    "gpt-2": [_GPT2],
    "mpt": [_GPT2],
    "olmo": [_GPT2],
    "jais": [_GPT2],
    "phi-2": [_GPT2],
    "llama3": [_LLAMA3],
    "llama-v3": [_LLAMA3],
    "llama-bpe": [_LLAMA3],
    "dbrx": [_LLAMA3],
    "smaug-bpe": [_LLAMA3],
    "falcon3": [_LLAMA3],
    "falcon-h1": [_LLAMA3],
    "pixtral": [_LLAMA3],
    "midm-2.0": [_LLAMA3],
    "llada": [_LLAMA3],
    "granite-docling": [_GPT2],
    "deepseek-llm": [
        "[\\r\\n]",
        # exact class from the model's tokenizer.json (escaped; a raw paste
        # normalizes lookalike codepoints like \u1f7d and breaks ranges)
        "\\s?[A-Za-z\u00b5\u00c0-\u00d6\u00d8-\u00f6\u00f8-\u01ba\u01bc-\u01bf"
        "\u01c4-\u0293\u0295-\u02af\u0370-\u0373\u0376\u0377\u037b-\u037d\u037f"
        "\u0386\u0388-\u038a\u038c\u038e-\u03a1\u03a3-\u03f5\u03f7-\u0481"
        "\u048a-\u052f\u0531-\u0556\u10a0-\u10c5\u13a0-\u13f5\u13f8-\u13fd"
        "\u1c90-\u1cba\u1cbd-\u1cbf\u1d00-\u1d2b\u1d6b-\u1d77\u1d79-\u1d9a"
        "\u1e00-\u1f15\u1f18-\u1f1d\u1f20-\u1f45\u1f48-\u1f4d\u1f50-\u1f57"
        "\u1f59\u1f5b\u1f5d\u1f5f-\u1f7d\u1f80-\u1fb4\u1fb6-\u1fbc\u1fbe"
        "\u1fc2-\u1fc4\u1fc6-\u1fcc\u1fd0-\u1fd3\u1fd6-\u1fdb\u1fe0-\u1fec"
        "\u1ff2-\u1ff4\u1ff6-\u1ffc\u2102\u2107\u210a-\u2113\u2115\u2119-\u211d"
        "\u2124\u2126\u2128\u212a-\u212d\u212f-\u2134\u2139\u213c-\u213f"
        "\u2145-\u2149\u214e\u2183\u2184\u2c00-\u2c7b\u2c7e-\u2ce4\u2ceb-\u2cee"
        "\u2cf2\u2cf3\ua640-\ua66d\ua680-\ua69b\ua722-\ua76f\ua771-\ua787"
        "\ua78b-\ua78e\uab70-\uabbf\ufb00-\ufb06\ufb13-\ufb17\uff21-\uff3a"
        "\uff41-\uff5a\U00010400-\U0001044f\U000104b0-\U000104d3"
        "\U000104d8-\U000104fb\U00010c80-\U00010cb2\U00010cc0-\U00010cf2"
        "\U000118a0-\U000118df\U0001e900-\U0001e943]+",
        "\\s?[!-/:-~\uff01-\uff0f\uff1a-\uff5e\u2018-\u201f\u3000-\u3002]+",
        "\\s+$",
        "[\u4e00-\u9fa5\u0800-\u4e00\uac00-\ud7ff]+",
        "\\p{N}+",
    ],
    "deepseek-coder": [
        r"[\r\n]",
        r"\s?\p{L}+",
        r"\s?\p{P}+",
        r"[一-龥ࠀ-一가-퟿]+",
        r"\p{N}",
    ],
    "deepseek-v3": [
        r"\p{N}{1,3}",
        r"[一-龥぀-ゟ゠-ヿ]+",
        r"[!\"#$%&'()*+,\-./:;<=>?@\[\\\]^_`{|}~][A-Za-z]+|[^\r\n\p{L}\p{P}\p{S}]?[\p{L}\p{M}]+| ?[\p{P}\p{S}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
    ],
    "falcon": [
        r"[\p{P}\$\+<=>\^~\|`]+",
        _GPT2,
        r"[0-9][0-9][0-9]",
    ],
    "starcoder": [r"\p{N}", _GPT2],
    "refact": [r"\p{N}", _GPT2],
    "command-r": [r"\p{N}", _GPT2],
    "smollm": [r"\p{N}", _GPT2],
    "codeshell": [r"\p{N}", _GPT2],
    "exaone": [r"\p{N}", _GPT2],
    "minerva-7b": [r"\p{N}", _GPT2],
    "qwen2": [_QWEN2],
    "stablelm2": [_QWEN2],
    "hunyuan": [_QWEN2],
    "glm4": [_LLAMA3],
    "chatglm-bpe": [_LLAMA3],
    "poro-chat": [r" ?[^(\s|.,!?…。，、।۔،)]+"],
    "bloom": [r" ?[^(\s|.,!?…。，、।۔،)]+"],
    "gpt3-finnish": [r" ?[^(\s|.,!?…。，、।۔،)]+"],
    "viking": [r" ?[^(\s|.,!?…。，、।۔،)]+", r"\p{N}"],
    "tekken": [
        r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+"
        r"|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*"
        r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"
    ],
    "gpt-4o": [
        r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])?"
        r"|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])?"
        r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"
    ],
}


# the remaining pre types of llama-vocab.cpp's llm_tokenizer_bpe switch

_GPT4O = (
    r"[^\r\n\p{L}\p{N}]?((?=[\p{L}])([^a-z]))*((?=[\p{L}])([^A-Z]))+"
    r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])?"
    r"|[^\r\n\p{L}\p{N}]?((?=[\p{L}])([^a-z]))+((?=[\p{L}])([^A-Z]))*"
    r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])?"
    r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
_DSV3 = [
    r"\p{N}{1,3}",
    "[\u4e00-\u9fa5\u3040-\u309f\u30a0-\u30ff]+",
    "[!\"#$%&'()*+,\\-./:;<=>?@\\[\\\\\\]^_`{|}~][A-Za-z]+"
    r"|[^\r\n\p{L}\p{P}\p{S}]?[\p{L}\p{M}]+| ?[\p{P}\p{S}]+[\r\n]*"
    r"|\s*[\r\n]+|\s+(?!\S)|\s+",
]

PRE_REGEX.update({
    # GPT-2 set aliases
    **{k: [_GPT2] for k in ("jina-es", "jina-de", "gigachat", "jina-v2-es",
                            "jina-v2-de", "a.x-4.0", "mellum", "modern-bert",
                            "jina-v1-en", "jina-v2-code", "roberta-bpe",
                            "exaone4", "trillion")},
    # qwen2 set aliases
    **{k: [_QWEN2] for k in ("deepseek-r1-qwen", "kormo", "f2llmv2",
                             "megrez", "solar-open", "grok-2")},
    # llama3 set aliases
    **{k: [_LLAMA3] for k in ("lfm2", "jina-v5-nano")},
    "jais-2": [
        r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])"
        r"|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*"
        r"|\s*[\r\n]+|\s{512}(?!\S)|\s{256}(?!\S)|\s{128}(?!\S)"
        r"|\s{64}(?!\S)|\s{32}(?!\S)|\s{16}(?!\S)|\s{8}(?!\S)"
        r"|\s{4}(?!\S)|\s{1,2}(?!\S)|\s{1}",
    ],
    "qwen35": [
        r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])"
        r"|[^\r\n\p{L}\p{N}]?[\p{L}\p{M}]+|\p{N}"
        r"| ?[^\s\p{L}\p{M}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
    ],
    # SPM-style BPE (spaces pre-normalized to U+2581; split on newlines only)
    "gemma4": ["[^\n]+|[\n]+"],
    "sarvam-moe": ["[^\n]+|[\n]+"],
    "youtu": [
        "[\uac00-\ud7a3\u3131-\u318e]+"
        "|[\uff01\u2026\u201c\u201d\u2018\u2019\u2014\uff1a\uff1b"
        "\uff0c\u3001\u3000-\u303f\ufe30-\ufe4f]+|[\u3105-\u312f]+"
        "|[\u4e00-\u9fa5\u3040-\u309f\u30a0-\u30ff]+",
        r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*"
        r"[\p{Ll}\p{Lm}\p{Lo}\p{M}]+"
        r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])?"
        r"|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+"
        r"[\p{Ll}\p{Lm}\p{Lo}\p{M}]*"
        r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])?"
        r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+",
    ],
    "hunyuan-dense": _DSV3,
    "joyai-llm": _DSV3,
    "llama4": [_GPT4O],
    "kanana2": [_GPT4O],
    "minimax-m2": [_GPT4O],
    "tiny_aya": [
        r"\d{1,3}(?=(?:\d{3})*\b)",
        r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*"
        r"[\p{Ll}\p{Lm}\p{Lo}\p{M}]+"
        r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])?"
        r"|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+"
        r"[\p{Ll}\p{Lm}\p{Lo}\p{M}]*"
        r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])?"
        r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+",
    ],
    "superbpe": [r"\p{N}+", r"(?=(\d{3})+(?!\d))"],
    **{k: [
        r"'(?:[sSdDmMtT]|[lL][lL]|[vV][eE]|[rR][eE])"
        r"|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*"
        r"|\s*[\r\n]|\s+(?!\S)|\s+",
    ] for k in ("bailingmoe", "bailingmoe2", "llada-moe")},
    "seed-coder": [
        r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])"
        r"|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1}| ?[^\s\p{L}\p{N}\r\n]+"
        r"|\s*[\r\n]+|\s+(?!\S)|\s+",
    ],
    "chameleon": [
        r"<sentinel:[0-9]+>",
        r"(IMGIMG)((A|B|C|D|E|F|G|H|I){1,4})Z",
        "([\t\n]|    |  )",
        r"\p{N}",
        r"[\p{P}!-/:-@\[-`{-~]",
        _GPT2,
    ],
    "exaone-moe": [
        r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])"
        r"|[^\r\n\p{L}\p{N}]?(?:\p{L}\p{M}*(?: \p{L}\p{M}*)*)+"
        r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n/]?|\s*[\r\n]|\s+(?!\S)|\s+",
    ],
    # approximations for custom-unicode.cpp handlers (documented drift):
    # afmoe's \p{AFMoE_digits} groups digits mod 3 like tiny_aya's pattern
    "afmoe": [
        r"\d{1,3}(?=(?:\d{3})*\b)",
        "[\u4e00-\u9fff\u3400-\u4dbf\uf900-\ufaff\u3040-\u309f"
        "\u30a0-\u30ff\uff65-\uff9f\u2f00-\u2fdf\u0e00-\u0e7f"
        "\u0e80-\u0eff\u1780-\u17ff\u1000-\u109f\uaa60-\uaa7f"
        "\ua9e0-\ua9ff\uac00-\ud7af\u1100-\u11ff]+",
        "[!\"#$%&'()*+,\\-./:;<=>?@\\[\\\\\\]^_`{|}~][A-Za-z]+"
        r"|[^\r\n\p{L}\p{P}\p{S}]?[\p{L}\p{M}]+| ?[\p{P}\p{S}]+[\r\n]*"
        r"|\s*[\r\n]+|\s+(?!\S)|\s+",
    ],
    # kimi-k2's custom K2 handler: Han runs first, then a gpt4o-style pass
    "kimi-k2": [r"\p{Han}+", _GPT4O],
})


# escapes that stand for a class: letter -> (table, negated)
_CLASS_ESCAPES = {"s": ("White_Space", False), "S": ("White_Space", True),
                  "d": ("Digit", False), "D": ("Digit", True),
                  "w": ("Word", False), "W": ("Word", True)}
# escapes both engines read alike
_PLAIN_ESCAPES = frozenset("rntfv")
_GROUPS = ("(?:", "(?=", "(?!", "(?<=", "(?<!")


def _cp(c: int) -> str:
    return f"\\u{c:04x}" if c <= 0xFFFF else f"\\U{c:08x}"


@functools.cache
def _spelled(name: str, negated: bool) -> str:
    """The class's ranges as the inside of an re set (its complement when
    negated, for a negated class within a set)."""
    rs = TABLES[name]
    if negated:
        comp, nxt = [], 0
        for a, b in rs:
            if a > nxt:
                comp.append((nxt, a - 1))
            nxt = b + 1
        if nxt <= 0x10FFFF:
            comp.append((nxt, 0x10FFFF))
        rs = comp
    return "".join(_cp(a) if a == b else f"{_cp(a)}-{_cp(b)}" for a, b in rs)


def _escape(pat: str, i: int) -> tuple[tuple, int]:
    """The escape at pat[i] == "\\" -> (("class", table, negated) |
    ("bound", negated) | ("text", s), index after it)."""
    if i + 1 >= len(pat):
        raise ValueError(f"pattern ends in a backslash: {pat!r}")
    ch = pat[i + 1]
    if ch in "pP":
        end = pat.find("}", i + 2)
        name = pat[i + 3:end] if pat.startswith("{", i + 2) and end > 0 else None
        if name not in TABLES:
            raise ValueError(f"unknown class \\{ch}{{{name}}} in {pat!r}")
        return ("class", name, ch == "P"), end + 1
    if ch in _CLASS_ESCAPES:
        return ("class",) + _CLASS_ESCAPES[ch], i + 2
    if ch in "bB":
        return ("bound", ch == "B"), i + 2
    if ch in _PLAIN_ESCAPES or not ch.isalnum():
        return ("text", pat[i: i + 2]), i + 2
    raise ValueError(f"escape \\{ch} has no translation to re: {pat!r}")


def _set(pat: str, i: int) -> tuple[str, int]:
    """The set opening at pat[i] == "[" -> (re set, index after it)."""
    j = i + 1
    neg = pat.startswith("^", j)
    j += neg
    items = []
    first = True
    while True:
        if j >= len(pat):
            raise ValueError(f"unterminated set in {pat!r}")
        ch = pat[j]
        if ch == "]" and not first:
            break
        first = False
        if ch == "\\":
            esc, j = _escape(pat, j)
            if esc[0] == "class":
                items.append(_spelled(esc[1], esc[2]))
            elif esc[0] == "bound":
                raise ValueError(f"\\b inside a set has no translation: {pat!r}")
            else:
                items.append(esc[1])
            continue
        if ch == "[" and pat.startswith(":", j + 1):
            raise ValueError(f"POSIX class in a set has no translation: {pat!r}")
        # ASCII punctuation escaped so re sees no set operation ("&&", "--"...);
        # "-" stays the range mark
        items.append("\\" + ch if ch.isascii() and not ch.isalnum() and ch != "-" else ch)
        j += 1
    return "[" + "^" * neg + "".join(items) + "]", j + 1


def translate(pat: str) -> str:
    """A ``regex`` pattern of PRE_REGEX -> the ``re`` pattern that matches
    the same strings, with every Unicode class spelled out as ranges."""
    out = []
    i = 0
    while i < len(pat):
        ch = pat[i]
        if ch == "\\":
            esc, i = _escape(pat, i)
            if esc[0] == "class":
                out.append(f"[{'^' * esc[2]}{_spelled(esc[1], False)}]")
            elif esc[0] == "bound":
                w = f"[{_spelled('Word', False)}]"
                out.append(f"(?:(?<={w})(?={w})|(?<!{w})(?!{w}))" if esc[1] else
                           f"(?:(?<={w})(?!{w})|(?<!{w})(?={w}))")
            else:
                out.append(esc[1])
        elif ch == "[":
            s, i = _set(pat, i)
            out.append(s)
        else:
            if ch == "(" and pat.startswith("(?", i) and not pat.startswith(_GROUPS, i):
                raise ValueError(f"group {pat[i:i + 4]!r} has no translation: {pat!r}")
            out.append(ch)
            i += 1
    return "".join(out)


@functools.cache
def _compiled(pat: str) -> re.Pattern:
    return re.compile(translate(pat))


def get_pre_regexes(pre: str) -> list:
    """The compiled patterns of a pre type (the default's for an unknown
    one), each translated at its first use."""
    return [_compiled(e) for e in PRE_REGEX.get(pre, PRE_REGEX["default"])]


def regex_split(text: str, patterns: list) -> list[str]:
    """Sequentially split text: each pattern further splits prior fragments;
    both matches and gaps survive as fragments (src/unicode.cpp semantics)."""
    frags = [text]
    for pat in patterns:
        nxt: list[str] = []
        for frag in frags:
            pos = 0
            for m in pat.finditer(frag):
                if m.start() > pos:
                    nxt.append(frag[pos: m.start()])
                if m.end() > m.start():
                    nxt.append(m.group())
                pos = m.end()
            if pos < len(frag):
                nxt.append(frag[pos:])
        frags = nxt
    return frags
