"""The port's tokenizer against the JAX package's on the CPU: the Unicode
range tables against the ``regex`` module on every code point, every
pre-tokenizer's split on a fixed corpus and on hypothesis text, and SPM and
byte-level BPE encode and decode on GGUFs that both packages read through
their own ``from_gguf``. Every comparison is exact equality."""
import re
import unicodedata

import numpy as np
import pytest
import regex
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tpullm.gguf.writer import GGUFWriter
from tpullm.tokenizer import Tokenizer as JTokenizer
from tpullm.tokenizer import pretokenizers as jpre
from tpullm.utils.synth import build_llama_gguf
from tpullm_torch.tokenizer import Tokenizer, Vocab
from tpullm_torch.tokenizer import pretokenizers as tpre
from tpullm_torch.tokenizer._gen_unicode_ranges import CLASSES, ranges_of
from tpullm_torch.tokenizer.unicode_ranges import TABLES
from tpullm_torch.utils.synth import synth_bpe_vocab

PRES = sorted(jpre.PRE_REGEX)

CORPUS = [
    "Hello world, here's a test! I'm sure you'LL see they'D 've 'Re 'S 'T 'M",
    "digits 1 12 123 1234 12345 123456 1234567 12345678 123456789 and 3.14159",
    "1,000,000 and 12,345.678 but 1000000000",
    "中文测试，汉字。 한국어 텍스트입니다 日本語のテキストとカタカナ",
    "combining: é ä ñ ạ̈ क्ष",
    "emoji 😀👍🏽 🇺🇸 👨‍👩‍👧 ❤️",
    "lines\r\nand\nmore\n\n\nand\r\r  trailing   \t\t\n",
    "\x1c\x1d\x1e\x1f separators x\x85y      nbsp 　ideo",
    "    leading and trailing    ",
    "<sentinel:12> IMGIMGABZ tabs\t\tand    four",
    "MixedCASE camelCase HTTPServer XMLHttpRequest ÉCOLE école ǅungla",
    "punct!!! ... ??? --- ((x)) [[y]] {z} @#$%^&*_+=|\\/~`",
    "Ελληνικά Русский текст العربية עברית हिन्दी ไทย",
    "",
    " ",
]


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_unicode_table_matches_regex(name):
    """Each table holds exactly the code points regex's class matches,
    over all of Unicode (surrogates included)."""
    assert list(TABLES[name]) == ranges_of(CLASSES[name])


def test_white_space_table_leaves_out_the_separators():
    """re's \\s takes U+001C-U+001F, regex's does not: the table follows
    regex, and the port's \\s the table."""
    spaces = {c for a, b in TABLES["White_Space"] for c in range(a, b + 1)}
    assert not {0x1C, 0x1D, 0x1E, 0x1F} & spaces and 0x85 in spaces
    assert all(re.match(r"\s", chr(c)) for c in range(0x1C, 0x20))
    pat = tpre._compiled(r"\s+")
    assert pat.findall("a\x1c\x1d b\x85c") == [" ", "\x85"]


@pytest.mark.parametrize("pre", PRES)
def test_pretokenizer_split_matches_jax_on_corpus(pre):
    assert tpre.PRE_REGEX[pre] == jpre.PRE_REGEX[pre]
    jp, tp = jpre.get_pre_regexes(pre), tpre.get_pre_regexes(pre)
    for text in CORPUS:
        assert tpre.regex_split(text, tp) == jpre.regex_split(text, jp), text


# text from code points Unicode 15.0 assigns (the standard library's
# unicodedata on Python 3.12), with the characters the patterns turn on
# drawn more often
_ASSIGNED = st.characters(exclude_categories=("Cn", "Cs"))
_PIVOTS = st.sampled_from(list(" \t\r\n\x0b\x0c\x1c\x1d\x1e\x1f\x85 　'sStTmMdDlLvVrReE"
                               "0123456789,.!?-_/$+<=>^~|`()[]{}中文가힣ぁァ́̈😀"))


@pytest.mark.parametrize("pre", PRES)
@settings(max_examples=25, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(text=st.text(st.one_of(_ASSIGNED, _PIVOTS), max_size=48))
def test_pretokenizer_split_matches_jax_on_hypothesis_text(pre, text):
    assert unicodedata.unidata_version == "15.0.0"
    assert tpre.regex_split(text, tpre.get_pre_regexes(pre)) == \
        jpre.regex_split(text, jpre.get_pre_regexes(pre))


@pytest.mark.parametrize("pattern", [r"\p{Greek}+", r"\X", r"\N{DASH}", r"(?i)a", r"[[:alpha:]]",
                                     r"[\b]", r"(?P<x>a)", r"\1", "\\"])
def test_translation_raises_on_what_it_cannot_map(pattern):
    with pytest.raises(ValueError):
        tpre.translate(pattern)


def test_translation_spells_classes_inside_and_outside_sets():
    out = tpre.translate(r"'s|\p{Lt}+")
    assert out.startswith("'s|[\\u01c5\\u01c8\\u01cb") and out.endswith("]+")
    pat = tpre._compiled(r"[^\s\p{L}]+|\d")
    assert pat.findall("ab 12,3١") == ["12,3١"]
    assert regex.findall(r"[^\s\p{L}]+|\d", "ab 12,3١") == ["12,3١"]


# ------------------------------------------------------------------- SPM


@pytest.fixture(scope="module")
def spm_pair(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spm") / "spm.gguf")
    build_llama_gguf(path, vocab_size=512, n_embd=64, n_layer=1, n_head=2, n_head_kv=1,
                     n_ff=64, with_vocab=True)
    return JTokenizer.from_gguf(path), Tokenizer.from_gguf(path)


SPM_TEXTS = ["hello world", "tok1 tok23tok4 abc", "<s>hi</s> there", " lead  double  spaces",
             "json {\"a\": [1, 2]} _-_ ok?!", "UPPER and ünïcödé fall to unk", "", "<s>"]


@pytest.mark.parametrize("add_special,parse_special", [(True, True), (True, False),
                                                       (False, True), (False, False)])
def test_spm_encode_decode_matches_jax(spm_pair, add_special, parse_special):
    jt, tt = spm_pair
    assert tt.vocab.model == "llama" and tt.vocab.n_tokens == 512
    for text in SPM_TEXTS:
        ids = tt.encode(text, add_special=add_special, parse_special=parse_special)
        assert ids == jt.encode(text, add_special=add_special, parse_special=parse_special)
        for skip in (False, True):
            assert tt.decode(ids, skip_special=skip) == jt.decode(ids, skip_special=skip)


def test_spm_round_trip_and_unknown(spm_pair):
    _, tt = spm_pair
    v = tt.vocab
    ids = tt.encode("hello world, 42!", add_special=True)
    assert ids[0] == v.bos_id and tt.decode(ids[1:]) == "hello world, 42!"
    assert tt.encode("é", add_special=False)[-1] == v.unk_id


# ------------------------------------------------------------------- BPE


def write_bpe_gguf(path: str, vocab: Vocab, extra_user: str | None = None) -> str:
    """Write a byte-level BPE vocab (with its specials and chat template)
    with the JAX package's GGUF writer. extra_user adds a user-defined
    token that strips the spaces left of it."""
    tokens, types = list(vocab.tokens), [1 if not a & 8 else 3 for a in vocab.attrs]
    if extra_user:
        tokens[300] = extra_user
        types[300] = 4
    w = GGUFWriter(path, arch="llama")
    w.add_string("tokenizer.ggml.model", "gpt2")
    w.add_string("tokenizer.ggml.pre", vocab.pre)
    w.add_array("tokenizer.ggml.tokens", tokens)
    w.add_array("tokenizer.ggml.token_type", np.asarray(types, np.int32))
    w.add_array("tokenizer.ggml.merges", vocab.merges)
    w.add_uint32("tokenizer.ggml.bos_token_id", vocab.bos_id)
    w.add_uint32("tokenizer.ggml.eos_token_id", vocab.eos_id)
    w.add_uint32("tokenizer.ggml.eot_token_id", vocab.eot_id)
    w.add_bool("tokenizer.ggml.add_bos_token", True)
    w.add_string("tokenizer.chat_template", vocab.chat_template)
    w.write()
    return path


@pytest.fixture(scope="module", params=["llama-bpe", "gpt-2", "qwen2"])
def bpe_pair(request, tmp_path_factory):
    pre = request.param
    path = str(tmp_path_factory.mktemp("bpe") / f"{pre}.gguf")
    write_bpe_gguf(path, synth_bpe_vocab(4096, pre=pre, seed=3), extra_user="<tool>")
    return JTokenizer.from_gguf(path), Tokenizer.from_gguf(path)


BPE_TEXTS = CORPUS + [
    "<|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\nhi there<|eot_id|>",
    "text <tool>  call <tool>x and <|eot_id|>tail",
    "the quick brown fox jumps over the lazy dog " * 4,
]


@pytest.mark.parametrize("add_special,parse_special", [(True, True), (True, False),
                                                       (False, True), (False, False)])
def test_bpe_encode_decode_matches_jax(bpe_pair, add_special, parse_special):
    jt, tt = bpe_pair
    assert tt.vocab.model == "gpt2" and tt.vocab.tokens[4096 - 256] == "<|begin_of_text|>"
    for text in BPE_TEXTS:
        ids = tt.encode(text, add_special=add_special, parse_special=parse_special)
        assert ids == jt.encode(text, add_special=add_special, parse_special=parse_special)
        for skip in (False, True):
            assert tt.decode(ids, skip_special=skip) == jt.decode(ids, skip_special=skip)


def test_bpe_round_trip_and_split_character(bpe_pair):
    """Text round-trips; a decode that ends inside a multi-byte character
    gives U+FFFD in both packages."""
    jt, tt = bpe_pair
    text = "naïve café 中文 😀 done"
    ids = tt.encode(text, add_special=False)
    assert tt.decode(ids) == text
    cut = [k for k in range(1, len(ids)) if tt.decode(ids[:k]).endswith("�")]
    assert cut, "no prefix ends inside a character"
    for k in cut:
        assert tt.decode(ids[:k]) == jt.decode(ids[:k])


def test_bpe_special_tokens(bpe_pair):
    jt, tt = bpe_pair
    v = tt.vocab
    ids = tt.encode("<|start_header_id|>user<|end_header_id|>", add_special=True,
                    parse_special=True)
    assert ids[0] == v.bos_id and ids[1] == v.bos_id + 6 and ids[-1] == v.bos_id + 7
    assert tt.decode(ids, skip_special=True) == "user"
    assert v.is_eog(v.eot_id) and v.is_eog(v.eos_id)
    literal = tt.encode("<|eot_id|>", add_special=False, parse_special=False)
    assert v.eot_id not in literal and tt.decode(literal) == "<|eot_id|>"
    assert tt.chat_template.startswith("{% set loop_messages")


def test_bpe_merges_english_words():
    tt = Tokenizer(synth_bpe_vocab(128256))
    text = "the quick brown fox jumps over the lazy dog"
    ids = tt.encode(text, add_special=False)
    assert len(ids) < len(text) // 2
    assert tt.decode(ids) == text


@pytest.mark.parametrize("model,family", [("bert", "WPM"), ("t5", "UGM"), ("rwkv", "RWKV"),
                                          ("plamo2", "PLaMo-2")])
def test_unported_family_raises(model, family):
    with pytest.raises(NotImplementedError, match=f"{model}.*{family}.*not ported"):
        Tokenizer(Vocab(model=model, tokens=["a"]))
