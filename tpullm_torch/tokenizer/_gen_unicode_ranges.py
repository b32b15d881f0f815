"""Rebuild ``unicode_ranges.py`` from the third-party ``regex`` module.

    python -m tpullm_torch.tokenizer._gen_unicode_ranges

The JAX package's pre-tokenizers run on ``regex``, whose Unicode tables are
newer than the standard library's ``unicodedata``, and whose ``\\s`` leaves
out U+001C-U+001F where ``re``'s takes them. The port runs its patterns on
``re`` with every class spelled out as code-point ranges, so the tables are
data taken from ``regex`` once, here. This is the one module of the port
that imports ``regex``; nothing imports it.
"""
from __future__ import annotations

from pathlib import Path

# table name -> the regex construct that defines it
CLASSES = {
    "L": r"\p{L}", "N": r"\p{N}", "P": r"\p{P}", "S": r"\p{S}", "M": r"\p{M}",
    "Lu": r"\p{Lu}", "Ll": r"\p{Ll}", "Lt": r"\p{Lt}", "Lm": r"\p{Lm}", "Lo": r"\p{Lo}",
    "Han": r"\p{Han}", "White_Space": r"\s", "Digit": r"\d", "Word": r"\w",
}


def ranges_of(construct: str) -> list[tuple[int, int]]:
    """Every code point regex's ``construct`` matches, as (first, last) runs."""
    import regex

    every = "".join(map(chr, range(0x110000)))
    return [(m.start(), m.end() - 1) for m in regex.finditer(f"(?:{construct})+", every)]


def render() -> str:
    import regex

    lines = ['"""Unicode classes of the pre-tokenizers as code-point ranges, taken from',
             f"the ``regex`` module {regex.__version__} by ``_gen_unicode_ranges.py``:",
             'do not edit by hand."""', "",
             f"REGEX_VERSION = {regex.__version__!r}", "",
             "TABLES: dict[str, tuple[tuple[int, int], ...]] = {"]
    for name, construct in CLASSES.items():
        lines.append(f"    # {construct}")
        lines.append(f"    {name!r}: (")
        pairs = [f"(0x{a:x}, 0x{b:x})," for a, b in ranges_of(construct)]
        row = "       "
        for p in pairs:
            if len(row) + 1 + len(p) > 92:
                lines.append(row)
                row = "       "
            row += " " + p
        lines.append(row)
        lines.append("    ),")
    lines.append("}")
    return "\n".join(lines) + "\n"


def main() -> None:
    out = Path(__file__).with_name("unicode_ranges.py")
    out.write_text(render())
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
