"""SPM and byte-level BPE tokenizers (llama.cpp-compatible).

The port's copy of tpullm/tokenizer/tokenizer.py for the two families its
server runs: SPM is the score-greedy bigram merge with byte fallback
(src/llama-vocab.cpp:110-279), BPE is rank-greedy pair merging over GPT-2
byte-encoded pre-tokenized words (:279-470, its pre-tokenizers on the
standard ``re``: ``pretokenizers.py``), and special tokens are partitioned
out of the raw text first, longest-first (tokenizer_st_partition :2916).
The WPM (bert), UGM (t5), RWKV and PLaMo-2 sessions are not ported: a
vocab of those families raises.
"""
from __future__ import annotations

import heapq

from ..gguf.reader import GGUFFile
from .pretokenizers import get_pre_regexes, regex_split
from .vocab import TokenAttr, Vocab


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2 byte -> printable unicode char map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_ENC = _bytes_to_unicode()
_BYTE_DEC = {v: k for k, v in _BYTE_ENC.items()}


class Tokenizer:
    """Facade dispatching on vocab.model: SPM ("llama") and BPE ("gpt2")."""

    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        if vocab.model in _UNPORTED:
            raise NotImplementedError(f"the {vocab.model} tokenizer ({_UNPORTED[vocab.model]}) "
                                      "is not ported to tpullm_torch yet")
        if vocab.model not in _SESSIONS:
            raise NotImplementedError(f"tokenizer model {vocab.model!r}")
        self._session = _SESSIONS[vocab.model](vocab)

    @property
    def chat_template(self) -> str | None:
        return self.vocab.chat_template

    @classmethod
    def from_gguf(cls, g: GGUFFile | str) -> "Tokenizer":
        if isinstance(g, str):
            g = GGUFFile(g)
        return cls(Vocab.from_gguf(g))

    # -- special-token partition (llama-vocab.cpp:2916) --

    def _partition(self, text: str, parse_special: bool):
        """-> list of ("text", str) | ("token", id) fragments."""
        frags: list[tuple[str, object]] = [("text", text)] if text else []
        v = self.vocab
        for sid in v.special_tokens:
            attr = v.attrs[sid]
            if not parse_special and (attr & (TokenAttr.CONTROL | TokenAttr.UNKNOWN)):
                continue
            stext = v.tokens[sid]
            out: list[tuple[str, object]] = []
            for kind, val in frags:
                if kind != "text":
                    out.append((kind, val))
                    continue
                rest = val
                while True:
                    i = rest.find(stext)
                    if i < 0:
                        if rest:
                            out.append(("text", rest))
                        break
                    left = rest[:i]
                    if attr & TokenAttr.LSTRIP:
                        left = left.rstrip()
                    if left:
                        out.append(("text", left))
                    out.append(("token", sid))
                    rest = rest[i + len(stext):]
                    if attr & TokenAttr.RSTRIP:
                        rest = rest.lstrip()
            frags = out
        return frags

    def encode(self, text: str, add_special: bool = True, parse_special: bool = False) -> list[int]:
        v = self.vocab
        out: list[int] = []
        frags = self._partition(text, parse_special)
        spm = isinstance(self._session, _SPM)
        prev_special = True
        if add_special and v.add_bos and v.bos_id is not None:
            out.append(v.bos_id)
        for kind, val in frags:
            if kind == "text":
                if spm:
                    t = (" " if (v.add_space_prefix and prev_special) else "") + val
                    self._session.tokenize(t.replace(" ", "▁"), out)
                else:
                    self._session.tokenize(val, out)
                prev_special = False
            else:
                out.append(val)
                prev_special = True
        if add_special and v.add_eos and v.eos_id is not None:
            out.append(v.eos_id)
        return out

    def decode(self, ids: list[int], skip_special: bool = False) -> str:
        v = self.vocab
        if isinstance(self._session, _SPM):  # SPM pieces
            buf = bytearray()
            for i in ids:
                a = v.attrs[i]
                if skip_special and (a & TokenAttr.CONTROL):
                    continue
                if a & TokenAttr.BYTE:
                    buf += bytes([int(v.tokens[i][3:5], 16)])
                elif a & TokenAttr.CONTROL or a & TokenAttr.UNKNOWN:
                    if not skip_special:
                        buf += v.tokens[i].encode()
                else:
                    buf += v.tokens[i].replace("▁", " ").encode()
            s = buf.decode("utf-8", errors="replace")
            return s[1:] if s.startswith(" ") and v.add_space_prefix else s
        parts = []
        for i in ids:
            a = v.attrs[i]
            if a & (TokenAttr.CONTROL | TokenAttr.USER_DEFINED | TokenAttr.UNKNOWN):
                if not skip_special:
                    parts.append(v.tokens[i].encode())
            else:
                parts.append(bytes(_BYTE_DEC[c] for c in v.tokens[i]))
        return b"".join(parts).decode("utf-8", errors="replace")


class _SPM:
    """Score-greedy bigram merge (llm_tokenizer_spm, llama-vocab.cpp:110)."""

    def __init__(self, vocab: Vocab):
        self.v = vocab

    def tokenize(self, text: str, out: list[int]) -> None:
        v = self.v
        if not text:
            return
        syms = list(text)  # unicode chars
        # (neg_score, left_index, seq) heap; lazy deletion via size checks
        nxt = list(range(1, len(syms))) + [-1]
        prv = [-1] + list(range(len(syms) - 1))
        alive = [True] * len(syms)
        rev_merge: dict[str, tuple[str, str]] = {}
        heap: list[tuple[float, int, str]] = []

        def try_add(li: int):
            ri = nxt[li]
            if li < 0 or ri < 0:
                return
            pair = syms[li] + syms[ri]
            tid = v.token_to_id.get(pair)
            if tid is None or v.attrs[tid] & (TokenAttr.UNUSED | TokenAttr.BYTE):
                return
            score = float(v.scores[tid]) if v.scores is not None else 0.0
            heapq.heappush(heap, (-score, li, pair))

        for i in range(len(syms) - 1):
            try_add(i)

        while heap:
            negs, li, pair = heapq.heappop(heap)
            ri = nxt[li] if li >= 0 else -1
            if li < 0 or ri < 0 or not alive[li] or not alive[ri]:
                continue
            if syms[li] + syms[ri] != pair:
                continue  # stale entry
            rev_merge[pair] = (syms[li], syms[ri])
            syms[li] = pair
            alive[ri] = False
            nxt[li] = nxt[ri]
            if nxt[ri] >= 0:
                prv[nxt[ri]] = li
            try_add(li)
            if prv[li] >= 0:
                try_add(prv[li])

        def resegment(s: str):
            tid = v.token_to_id.get(s)
            if tid is not None and not (v.attrs[tid] & TokenAttr.UNUSED):
                out.append(tid)
                return
            if s in rev_merge:
                l, r = rev_merge[s]
                resegment(l)
                resegment(r)
                return
            for b in s.encode("utf-8"):
                try:
                    out.append(v.byte_to_id(b))
                except KeyError:
                    if v.unk_id is not None:
                        out.append(v.unk_id)

        i = 0
        while i >= 0 and i < len(syms):
            if alive[i]:
                resegment(syms[i])
            i = nxt[i]


# pre types whose tokenizers set ignore_merges: a whole word already in the
# vocab is emitted directly without running merges (llama-vocab.cpp:585 +
# the per-pre flags at :1969,1987,2077)
_IGNORE_MERGES_PRES = frozenset({
    "llama3", "llama-v3", "llama-bpe", "falcon3", "falcon-h1", "pixtral",
    "midm-2.0", "lfm2", "jina-v5-nano", "youtu", "tekken",
})


class _BPE:
    """Rank-greedy byte-level BPE (llm_tokenizer_bpe, llama-vocab.cpp:279)."""

    def __init__(self, vocab: Vocab):
        self.v = vocab
        self.ranks = {tuple(m.split(" ", 1)): r for r, m in enumerate(vocab.merges)}
        self.patterns = get_pre_regexes(vocab.pre)
        self.ignore_merges = vocab.pre in _IGNORE_MERGES_PRES

    def tokenize(self, text: str, out: list[int]) -> None:
        v = self.v
        for word in regex_split(text, self.patterns):
            enc = "".join(_BYTE_ENC[b] for b in word.encode("utf-8"))
            if self.ignore_merges:
                tid = v.token_to_id.get(enc)
                if tid is not None:
                    out.append(tid)
                    continue
            parts = self._merge(enc)
            for p in parts:
                tid = v.token_to_id.get(p)
                if tid is not None:
                    out.append(tid)
                else:
                    for ch in p:
                        tid = v.token_to_id.get(ch)
                        if tid is not None:
                            out.append(tid)

    def _merge(self, word: str) -> list[str]:
        parts = list(word)
        if len(parts) < 2:
            return parts
        while True:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_i < 0:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return parts


# the families whose sessions are not ported: tokenizer model -> session
_UNPORTED = {"bert": "WPM", "t5": "UGM", "rwkv": "RWKV", "plamo2": "PLaMo-2"}
_SESSIONS = {"llama": _SPM, "gpt2": _BPE}
