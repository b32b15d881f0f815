"""The port's tokenizer: SPM and byte-level BPE, with the BPE
pre-tokenizers on the standard ``re`` (no third-party ``regex``)."""
from .tokenizer import Tokenizer
from .vocab import TokenAttr, Vocab

__all__ = ["Vocab", "TokenAttr", "Tokenizer"]
