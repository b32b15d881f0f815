"""Minimal Jinja2-subset interpreter for chat templates.

The port's copy of tpullm/server/jinja.py (standard library only). The
reference bundles a full Jinja engine (common/jinja/{lexer,parser,
runtime,value}) because HF `tokenizer.chat_template` strings drive chat
formatting. This is a compact recursive-descent subset covering what chat
templates actually use:

  {{ expr }}  {% if/elif/else/endif %}  {% for x in seq %}{% endfor %}
  {% set name = expr %}  {#- comments -#}  whitespace-control dashes
  literals (str/num/bool/none/list/dict), attr + index access, method calls
  (.strip/.startswith/.endswith/.upper/.lower/.title/.replace/.split/.rstrip/.lstrip/.get/.items),
  filters (trim, join, length, first, last, upper, lower, title, tojson,
  string, int, default, replace, list, selectattr minus, safe, capitalize),
  tests (defined, none, string, mapping, iterable, number),
  operators: == != < <= > >= in not in and or not + - * % ~ if-else ternary,
  loop.{index0,index,first,last,length}, raise_exception(), namespace().

No sandbox escape surface: only the whitelisted methods/filters exist.
"""
from __future__ import annotations

import json
import re


class TemplateError(ValueError):
    pass


class _RaiseException(Exception):
    pass


# ----------------------------------------------------------- tokenization

_TOKEN_RE = re.compile(
    r"(?s)(\{\{-?.*?-?\}\}|\{%-?.*?-?%\}|\{#-?.*?-?#\})")


def _lex(src: str):
    """-> list of ('text', s) | ('expr', s) | ('stmt', s) with whitespace
    control applied."""
    parts = _TOKEN_RE.split(src)
    out = []
    for p in parts:
        if not p:
            continue
        if p.startswith("{{"):
            body = p[2:-2]
            out.append(["expr", body.strip("-").strip(),
                        body.startswith("-"), body.endswith("-")])
        elif p.startswith("{%"):
            body = p[2:-2]
            out.append(["stmt", body.strip("-").strip(),
                        body.startswith("-"), body.endswith("-")])
        elif p.startswith("{#"):
            body = p[2:-2]
            out.append(["comment", "", body.startswith("-"), body.endswith("-")])
        else:
            out.append(["text", p, False, False])
    # whitespace control: a leading '-' trims the PREVIOUS text's tail,
    # a trailing '-' trims the NEXT text's head
    for i, t in enumerate(out):
        if t[0] in ("expr", "stmt", "comment"):
            if t[2] and i > 0 and out[i - 1][0] == "text":
                out[i - 1][1] = out[i - 1][1].rstrip()
            if t[3] and i + 1 < len(out) and out[i + 1][0] == "text":
                out[i + 1][1] = out[i + 1][1].lstrip()
    return [(t[0], t[1]) for t in out if t[0] != "comment"]


# ------------------------------------------------------- expression parser

_EXPR_TOKEN = re.compile(r"""
    (?P<str>'(?:\\.|[^'\\])*'|"(?:\\.|[^"\\])*")
  | (?P<num>\d+\.\d+|\d+)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>==|!=|<=|>=|\*\*|[-+*/%~<>()\[\]{}.,:|=])
  | (?P<ws>\s+)
""", re.X)


def _tok_expr(s: str):
    toks = []
    i = 0
    while i < len(s):
        m = _EXPR_TOKEN.match(s, i)
        if not m:
            raise TemplateError(f"bad expression at {s[i:i+20]!r}")
        i = m.end()
        if m.lastgroup == "ws":
            continue
        toks.append((m.lastgroup, m.group()))
    toks.append(("end", ""))
    return toks


class _Namespace:
    def __init__(self, **kw):
        self.__dict__.update(kw)


class _ExprParser:
    def __init__(self, toks, env):
        self.t = toks
        self.i = 0
        self.env = env

    def peek(self):
        return self.t[self.i]

    def next(self):
        t = self.t[self.i]
        self.i += 1
        return t

    def expect(self, val):
        k, v = self.next()
        if v != val:
            raise TemplateError(f"expected {val!r}, got {v!r}")

    # precedence: ternary < or < and < not < cmp < ~ < +- < */% < unary < postfix
    def parse(self):
        return self.ternary()

    def ternary(self):
        v = self.or_()
        if self.peek() == ("name", "if"):
            self.next()
            cond = self.or_()
            if self.peek() == ("name", "else"):
                self.next()
                other = self.ternary()
            else:
                other = ""
            return v if _truth(cond) else other
        return v

    def or_(self):
        v = self.and_()
        while self.peek() == ("name", "or"):
            self.next()
            r = self.and_()
            v = v if _truth(v) else r
        return v

    def and_(self):
        v = self.not_()
        while self.peek() == ("name", "and"):
            self.next()
            r = self.not_()
            v = r if _truth(v) else v
        return v

    def not_(self):
        if self.peek() == ("name", "not"):
            self.next()
            return not _truth(self.not_())
        return self.cmp()

    def cmp(self):
        v = self.concat()
        while True:
            k, op = self.peek()
            if op in ("==", "!=", "<", "<=", ">", ">="):
                self.next()
                r = self.concat()
                v = {"==": v == r, "!=": v != r, "<": v < r, "<=": v <= r,
                     ">": v > r, ">=": v >= r}[op]
            elif self.peek() == ("name", "in"):
                self.next()
                r = self.concat()
                v = v in r if r is not None else False
            elif self.peek() == ("name", "not") and self.t[self.i + 1] == ("name", "in"):
                self.next(); self.next()
                r = self.concat()
                v = v not in r
            elif self.peek() == ("name", "is"):
                self.next()
                neg = False
                if self.peek() == ("name", "not"):
                    neg = True
                    self.next()
                _, test = self.next()
                r = _apply_test(v, test)
                v = (not r) if neg else r
            else:
                return v

    def concat(self):
        v = self.add()
        while self.peek() == ("op", "~"):
            self.next()
            v = _str(v) + _str(self.add())
        return v

    def add(self):
        v = self.mul()
        while self.peek()[1] in ("+", "-") and self.peek()[0] == "op":
            _, op = self.next()
            r = self.mul()
            v = v + r if op == "+" else v - r
        return v

    def mul(self):
        v = self.unary()
        while self.peek()[1] in ("*", "/", "%") and self.peek()[0] == "op":
            _, op = self.next()
            r = self.unary()
            v = {"*": v * r, "/": v / r, "%": v % r}[op]
        return v

    def unary(self):
        if self.peek() == ("op", "-"):
            self.next()
            return -self.unary()
        return self.postfix()

    def postfix(self):
        v = self.atom()
        while True:
            k, t = self.peek()
            if t == ".":
                self.next()
                _, name = self.next()
                if self.peek() == ("op", "("):
                    args = self.call_args()
                    v = _call_method(v, name, args)
                else:
                    v = _getattr(v, name)
            elif t == "[":
                self.next()
                idx = self.parse()
                self.expect("]")
                v = _getitem(v, idx)
            elif t == "|":
                self.next()
                _, name = self.next()
                args = self.call_args() if self.peek() == ("op", "(") else []
                v = _apply_filter(v, name, args)
            elif t == "(":
                args = self.call_args()
                v = _call_func(v, args)
            else:
                return v

    def call_args(self):
        self.expect("(")
        args = []
        while self.peek() != ("op", ")"):
            # keyword args evaluated, name discarded (filters use positional)
            if (self.peek()[0] == "name"
                    and self.t[self.i + 1] == ("op", "=")):
                self.next(); self.next()
            args.append(self.parse())
            if self.peek() == ("op", ","):
                self.next()
        self.expect(")")
        return args

    def atom(self):
        k, t = self.next()
        if k == "str":
            return _unescape(t[1:-1])
        if k == "num":
            return float(t) if "." in t else int(t)
        if k == "name":
            if t == "true" or t == "True":
                return True
            if t == "false" or t == "False":
                return False
            if t in ("none", "None", "null"):
                return None
            if t == "raise_exception":
                args = self.call_args()
                raise _RaiseException(str(args[0]) if args else "")
            if t == "namespace":
                args_start = self.i
                # namespace(a=1, ...) -> object with attrs
                self.expect("(")
                ns = _Namespace()
                while self.peek() != ("op", ")"):
                    _, nm = self.next()
                    self.expect("=")
                    setattr(ns, nm, self.parse())
                    if self.peek() == ("op", ","):
                        self.next()
                self.expect(")")
                return ns
            if t in self.env:
                return self.env[t]
            return _UNDEFINED
        if t == "(":
            v = self.parse()
            self.expect(")")
            return v
        if t == "[":
            out = []
            while self.peek() != ("op", "]"):
                out.append(self.parse())
                if self.peek() == ("op", ","):
                    self.next()
            self.expect("]")
            return out
        if t == "{":
            d = {}
            while self.peek() != ("op", "}"):
                key = self.parse()
                self.expect(":")
                d[key] = self.parse()
                if self.peek() == ("op", ","):
                    self.next()
            self.expect("}")
            return d
        raise TemplateError(f"unexpected token {t!r}")


class _Undefined:
    def __repr__(self):
        return ""

    def __bool__(self):
        return False

    def __eq__(self, other):
        return isinstance(other, _Undefined)

    def __ne__(self, other):
        return not isinstance(other, _Undefined)

    def __hash__(self):
        return 0


_UNDEFINED = _Undefined()


def _unescape(s: str) -> str:
    return (s.replace("\\n", "\n").replace("\\t", "\t").replace("\\'", "'")
            .replace('\\"', '"').replace("\\\\", "\\"))


def _truth(v) -> bool:
    if isinstance(v, _Undefined):
        return False
    return bool(v)


def _str(v) -> str:
    if v is None or isinstance(v, _Undefined):
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def _getattr(v, name):
    if isinstance(v, dict):
        return v.get(name, _UNDEFINED)
    if isinstance(v, _Namespace):
        return getattr(v, name, _UNDEFINED)
    return getattr(v, name, _UNDEFINED) if not callable(getattr(v, name, None)) \
        else getattr(v, name)


def _getitem(v, idx):
    try:
        if isinstance(idx, float):
            idx = int(idx)
        return v[idx]
    except (KeyError, IndexError, TypeError):
        return _UNDEFINED


_METHODS = {
    "strip", "lstrip", "rstrip", "upper", "lower", "title", "replace",
    "startswith", "endswith", "split", "join", "get", "items", "keys",
    "values", "append", "capitalize", "find", "rfind", "count", "format",
    "pop", "insert",
}


def _call_method(v, name, args):
    if name not in _METHODS:
        raise TemplateError(f"method {name!r} not allowed")
    if isinstance(v, _Undefined):
        return _UNDEFINED
    m = getattr(v, name, None)
    if m is None:
        return _UNDEFINED
    out = m(*args)
    return list(out) if name in ("items", "keys", "values") else out


def _call_func(v, args):
    raise TemplateError("only raise_exception()/namespace() calls allowed")


def _apply_filter(v, name, args):
    if name == "trim":
        return _str(v).strip()
    if name == "join":
        sep = args[0] if args else ""
        return sep.join(_str(x) for x in v)
    if name == "length":
        return len(v)
    if name == "first":
        return v[0] if v else _UNDEFINED
    if name == "last":
        return v[-1] if v else _UNDEFINED
    if name == "upper":
        return _str(v).upper()
    if name == "lower":
        return _str(v).lower()
    if name == "title":
        return _str(v).title()
    if name == "capitalize":
        return _str(v).capitalize()
    if name == "tojson":
        return json.dumps(v, ensure_ascii=False)
    if name == "string":
        return _str(v)
    if name == "int":
        return int(v)
    if name == "default":
        if isinstance(v, _Undefined) or v is None or (
                len(args) > 1 and args[1] and not v):
            return args[0] if args else ""
        return v
    if name == "replace":
        return _str(v).replace(args[0], args[1])
    if name == "list":
        return list(v)
    if name == "safe":
        return v
    if name == "strip":
        return _str(v).strip()
    if name == "abs":
        return abs(v)
    if name == "selectattr":  # minimal: selectattr('key','equalto',val)
        key = args[0]
        if len(args) >= 3 and args[1] == "equalto":
            return [x for x in v if _getattr(x, key) == args[2]]
        return [x for x in v if _truth(_getattr(x, key))]
    if name == "map":  # map(attribute='k')
        return [_getattr(x, args[0]) for x in v]
    if name == "reject":
        return v
    if name == "sort":
        return sorted(v)
    if name == "unique":
        seen, out = set(), []
        for x in v:
            if x not in seen:
                seen.add(x)
                out.append(x)
        return out
    raise TemplateError(f"filter {name!r} not supported")


def _apply_test(v, test):
    if test == "defined":
        return not isinstance(v, _Undefined)
    if test == "undefined":
        return isinstance(v, _Undefined)
    if test == "none":
        return v is None
    if test == "string":
        return isinstance(v, str)
    if test == "mapping":
        return isinstance(v, dict)
    if test == "iterable":
        return hasattr(v, "__iter__")
    if test == "number":
        return isinstance(v, (int, float)) and not isinstance(v, bool)
    if test == "sequence":
        return isinstance(v, (list, tuple, str))
    if test in ("true", "false"):
        return v is (test == "true")
    raise TemplateError(f"test {test!r} not supported")


# ------------------------------------------------------------ template AST

class _Node:
    pass


class _Text(_Node):
    def __init__(self, s):
        self.s = s


class _Expr(_Node):
    def __init__(self, src):
        self.src = src


class _If(_Node):
    def __init__(self):
        self.branches = []  # (cond_src|None, body)


class _For(_Node):
    def __init__(self, var, var2, src, body, else_body):
        self.var, self.var2, self.src = var, var2, src
        self.body, self.else_body = body, else_body


class _Set(_Node):
    def __init__(self, target, src):
        self.target, self.src = target, src


def _parse_block(toks, i, terminators):
    body = []
    while i < len(toks):
        kind, s = toks[i]
        if kind == "text":
            body.append(_Text(s))
            i += 1
        elif kind == "expr":
            body.append(_Expr(s))
            i += 1
        else:  # stmt
            word = s.split(None, 1)[0] if s.strip() else ""
            if word in terminators:
                return body, i
            i += 1
            if word == "if":
                node = _If()
                cond = s[2:].strip()
                while True:
                    blk, i = _parse_block(toks, i, ("elif", "else", "endif"))
                    node.branches.append((cond, blk))
                    w2 = toks[i][1].split(None, 1)[0]
                    if w2 == "elif":
                        cond = toks[i][1][4:].strip()
                        i += 1
                    elif w2 == "else":
                        i += 1
                        blk, i = _parse_block(toks, i, ("endif",))
                        node.branches.append((None, blk))
                        i += 1
                        break
                    else:
                        i += 1
                        break
                body.append(node)
            elif word == "for":
                m = re.match(r"for\s+(\w+)(?:\s*,\s*(\w+))?\s+in\s+(.*)", s, re.S)
                if not m:
                    raise TemplateError(f"bad for: {s!r}")
                blk, i = _parse_block(toks, i, ("endfor", "else"))
                else_blk = []
                if toks[i][1].split(None, 1)[0] == "else":
                    i += 1
                    else_blk, i = _parse_block(toks, i, ("endfor",))
                i += 1
                body.append(_For(m.group(1), m.group(2), m.group(3), blk, else_blk))
            elif word == "set":
                m = re.match(r"set\s+([\w.]+)\s*=\s*(.*)", s, re.S)
                if not m:
                    raise TemplateError(f"bad set: {s!r}")
                body.append(_Set(m.group(1), m.group(2)))
            elif word in ("break", "continue"):
                body.append(_Text(""))  # rare in chat templates; no-op
            elif word == "generation" or word == "endgeneration":
                pass  # {% generation %} markers: transparent
            else:
                raise TemplateError(f"unsupported statement {word!r}")
    return body, i


class Template:
    def __init__(self, src: str):
        toks = _lex(src)
        self.body, _ = _parse_block(toks, 0, ())

    def render(self, **env) -> str:
        out = []
        env = dict(env)
        self._exec(self.body, env, out)
        return "".join(out)

    def _eval(self, src, env):
        return _ExprParser(_tok_expr(src), env).parse()

    def _exec(self, body, env, out):
        for node in body:
            if isinstance(node, _Text):
                out.append(node.s)
            elif isinstance(node, _Expr):
                out.append(_str(self._eval(node.src, env)))
            elif isinstance(node, _Set):
                val = self._eval(node.src, env)
                if "." in node.target:  # namespace attr
                    obj, attr = node.target.rsplit(".", 1)
                    setattr(env[obj], attr, val)
                else:
                    env[node.target] = val
            elif isinstance(node, _If):
                for cond, blk in node.branches:
                    if cond is None or _truth(self._eval(cond, env)):
                        self._exec(blk, env, out)
                        break
            elif isinstance(node, _For):
                seq = self._eval(node.src, env)
                if isinstance(seq, _Undefined) or seq is None:
                    seq = []
                if isinstance(seq, dict):
                    seq = list(seq.items())
                seq = list(seq)
                if not seq and node.else_body:
                    self._exec(node.else_body, env, out)
                for idx, item in enumerate(seq):
                    if node.var2 is not None:
                        env[node.var], env[node.var2] = item
                    else:
                        env[node.var] = item
                    env["loop"] = {
                        "index0": idx, "index": idx + 1,
                        "first": idx == 0, "last": idx == len(seq) - 1,
                        "length": len(seq),
                        "revindex": len(seq) - idx,
                        "previtem": seq[idx - 1] if idx else _UNDEFINED,
                        "nextitem": seq[idx + 1] if idx + 1 < len(seq) else _UNDEFINED,
                    }
                    self._exec(node.body, env, out)


def render_chat_template(template_src: str, messages: list[dict],
                         add_generation_prompt: bool = True,
                         bos_token: str = "", eos_token: str = "",
                         **extra) -> str:
    """Execute a tokenizer.chat_template with HF-compatible globals."""
    t = Template(template_src)
    try:
        return t.render(
            messages=messages,
            add_generation_prompt=add_generation_prompt,
            bos_token=bos_token, eos_token=eos_token,
            tools=extra.pop("tools", None) or None,
            **extra,
        )
    except _RaiseException as e:
        raise TemplateError(f"template raised: {e}")
