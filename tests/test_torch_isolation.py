"""The PyTorch port stands alone: importing it loads neither JAX nor the JAX
package, its sources import neither, and its entry points run on the card
by default and raise without one rather than fall back to the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "tpullm_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def test_import_loads_no_jax_and_no_tpullm():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'tpullm' or m.startswith('tpullm.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")))
def test_sources_import_no_jax_or_tpullm(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "tpullm"), (path, n)


def test_chip_smoke_imports_no_jax_or_tpullm():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "tpullm"), n


def test_entry_points_default_to_cuda_and_raise_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from tpullm_torch.models.config import ModelConfig
    from tpullm_torch.runtime.engine import InferenceEngine
    from tpullm_torch.runtime.loader import load_model
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    with pytest.raises(RuntimeError, match="cuda"):
        load_model(str(tmp_path / "absent.gguf"))
    cfg, params = synth_kmajor_q4k_fast(vocab_size=256, n_embd=256, n_layer=1, n_head=2,
                                        n_head_kv=1, n_ff=512, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        synth_kmajor_q4k_fast(vocab_size=256, n_embd=256, n_layer=1, n_head=2,
                              n_head_kv=1, n_ff=512)
    assert isinstance(cfg, ModelConfig)


# the one module that reads the third-party regex: it rebuilds the tables
REGEX_GENERATOR = "tpullm_torch/tokenizer/_gen_unicode_ranges.py"


def test_no_module_but_the_range_generator_imports_regex():
    """The port needs no third-party ``regex``: its pre-tokenizers run on
    the standard ``re`` over tables written as data."""
    users = set()
    for p in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0
                     else [])
            if any(n.split(".")[0] == "regex" for n in names):
                users.add(str(p.relative_to(ROOT)))
    assert users == {REGEX_GENERATOR}


def test_tokenizer_and_server_import_and_run_without_regex():
    """With ``regex`` made unimportable, every module of the tokenizer and
    the server imports, every pre-tokenizer pattern translates and compiles,
    and a byte-level BPE tokenizer encodes and decodes text."""
    mods = [m for m in MODULES if m.startswith(("tpullm_torch.tokenizer", "tpullm_torch.server"))
            and not m.endswith("_gen_unicode_ranges")]
    code = (
        "import importlib, sys\n"
        "sys.modules['regex'] = None\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from tpullm_torch.tokenizer import Tokenizer, pretokenizers as P\n"
        "from tpullm_torch.utils.synth import synth_bpe_vocab\n"
        "for pre in P.PRE_REGEX: P.get_pre_regexes(pre)\n"
        "tok = Tokenizer(synth_bpe_vocab(1024))\n"
        "text = 'Hello, wörld! 123 中文\\r\\n'\n"
        "assert tok.decode(tok.encode(text, add_special=False)) == text\n"
        "assert sys.modules['regex'] is None\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
