"""Vocabulary loaded from GGUF metadata.

The port's copy of tpullm/tokenizer/vocab.py, read through the port's GGUF
reader; it also keeps the file's chat template. Counterpart of llama_vocab
(src/llama-vocab.cpp:2100-2800): token texts, scores, per-token attribute
flags, special-token ids, and the caches used by tokenization
(special-token list sorted by length, byte-token map).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from ..gguf.constants import Keys
from ..gguf.reader import GGUFFile


class TokenAttr(enum.IntFlag):
    UNDEFINED = 0
    UNKNOWN = 1 << 0
    UNUSED = 1 << 1
    NORMAL = 1 << 2
    CONTROL = 1 << 3
    USER_DEFINED = 1 << 4
    BYTE = 1 << 5
    LSTRIP = 1 << 6
    RSTRIP = 1 << 7


# GGUF token_type values (gguf-py TokenType)
_TYPE_TO_ATTR = {
    1: TokenAttr.NORMAL,
    2: TokenAttr.UNKNOWN,
    3: TokenAttr.CONTROL,
    4: TokenAttr.USER_DEFINED,
    5: TokenAttr.UNUSED,
    6: TokenAttr.BYTE,
}


@dataclass
class Vocab:
    model: str = "llama"  # llama (SPM) | gpt2 (BPE) | bert (WPM) | t5 (UGM) | rwkv
    pre: str = "default"
    tokens: list[str] = field(default_factory=list)
    scores: np.ndarray | None = None
    attrs: list[TokenAttr] = field(default_factory=list)
    merges: list[str] = field(default_factory=list)
    bos_id: int | None = None
    eos_id: int | None = None
    eot_id: int | None = None
    unk_id: int | None = None
    sep_id: int | None = None
    pad_id: int | None = None
    add_bos: bool = False
    add_eos: bool = False
    add_space_prefix: bool = True
    fim_pre_id: int | None = None
    fim_suf_id: int | None = None
    fim_mid_id: int | None = None
    cls_id: int | None = None
    mask_id: int | None = None
    remove_extra_whitespaces: bool = False
    escape_whitespaces: bool = True
    treat_whitespace_as_suffix: bool = False
    precompiled_charsmap: bytes = b""  # UGM normalization (XCDA + repls)
    chat_template: str | None = None  # tokenizer.chat_template (Jinja)
    # caches
    token_to_id: dict[str, int] = field(default_factory=dict, repr=False)
    special_tokens: list[int] = field(default_factory=list, repr=False)
    byte_tokens: dict[int, int] = field(default_factory=dict, repr=False)

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    @classmethod
    def from_gguf(cls, g: GGUFFile) -> "Vocab":
        K = Keys.Tokenizer
        v = cls(
            model=str(g.get(K.MODEL, "llama")),
            pre=str(g.get(K.PRE, "default")),
            tokens=list(g.get(K.LIST, []) or []),
            merges=list(g.get(K.MERGES, []) or []),
        )
        scores = g.get(K.SCORES)
        v.scores = np.asarray(scores, np.float32) if scores is not None else None
        ttypes = g.get(K.TOKEN_TYPE)
        if ttypes is not None:
            v.attrs = [_TYPE_TO_ATTR.get(int(t), TokenAttr.UNDEFINED) for t in ttypes]
        else:
            v.attrs = [TokenAttr.NORMAL] * len(v.tokens)

        def _id(key, default=None):
            x = g.get(key)
            return int(x) if x is not None else default

        # plamo2 shares SPM-style defaults: bos=1 eos=2 unk=0 (+pad=3)
        # (llama-vocab.cpp:1892-1900)
        spm_like = v.model in ("llama", "plamo2")
        v.bos_id = _id(K.BOS_ID, 1 if spm_like else None)
        v.eos_id = _id(K.EOS_ID, 2 if spm_like else None)
        v.eot_id = _id(K.EOT_ID)
        v.unk_id = _id(K.UNK_ID, 0 if spm_like else None)
        v.sep_id = _id(K.SEP_ID)
        v.pad_id = _id(K.PAD_ID, 3 if v.model == "plamo2" else None)
        v.cls_id = _id("tokenizer.ggml.cls_token_id")
        v.mask_id = _id("tokenizer.ggml.mask_token_id")
        v.fim_pre_id = _id(getattr(K, "FIM_PRE_ID", "tokenizer.ggml.fim_pre_token_id"))
        v.fim_suf_id = _id(getattr(K, "FIM_SUF_ID", "tokenizer.ggml.fim_suf_token_id"))
        v.fim_mid_id = _id(getattr(K, "FIM_MID_ID", "tokenizer.ggml.fim_mid_token_id"))
        v.add_bos = bool(g.get(K.ADD_BOS, v.model == "llama"))
        v.add_eos = bool(g.get(K.ADD_EOS, False))
        default_prefix = v.model == "llama"  # SPM defaults true, BPE false
        v.add_space_prefix = bool(g.get(K.ADD_SPACE_PREFIX, default_prefix))
        v.remove_extra_whitespaces = bool(g.get(K.REMOVE_EXTRA_WS, False))
        v.escape_whitespaces = bool(g.get(K.ESCAPE_WS, True))
        v.treat_whitespace_as_suffix = bool(g.get(K.WS_SUFFIX, False))
        pc = g.get(K.PRECOMPILED_CHARSMAP)
        if pc is not None:
            import numpy as _np

            v.precompiled_charsmap = (bytes(pc) if isinstance(pc, (bytes, bytearray))
                                      else _np.asarray(pc, _np.uint8).tobytes())
        tmpl = g.get(K.CHAT_TEMPLATE)
        v.chat_template = str(tmpl) if tmpl is not None else None
        v._build_caches()
        return v

    def _build_caches(self) -> None:
        self.token_to_id = {t: i for i, t in enumerate(self.tokens)}
        special = TokenAttr.CONTROL | TokenAttr.USER_DEFINED | TokenAttr.UNKNOWN
        self.special_tokens = [
            i for i, a in enumerate(self.attrs) if (a & special) and self.tokens[i]
        ]
        # longest-first so overlapping specials match greedily (llama-vocab.cpp:2708)
        self.special_tokens.sort(key=lambda i: -len(self.tokens[i]))
        self.byte_tokens = {}
        for i, (t, a) in enumerate(zip(self.tokens, self.attrs)):
            if a & TokenAttr.BYTE and len(t) == 6 and t.startswith("<0x"):
                self.byte_tokens[int(t[3:5], 16)] = i

    def byte_to_id(self, b: int) -> int:
        if b in self.byte_tokens:
            return self.byte_tokens[b]
        # SPM fallback: byte tokens at id = byte + 3 (llama.cpp byte_to_token)
        raise KeyError(f"no byte token for 0x{b:02x}")

    def is_eog(self, tok: int) -> bool:
        return tok in (self.eos_id, self.eot_id)
