#!/usr/bin/env python3
"""Kernel D's rows of chip_smoke.py's phase 2, on one NVIDIA H100, for one
checkout's tpullm_torch or for several in turns.

    python3 scripts/layer_kernel_rows.py                # this checkout
    python3 scripts/layer_kernel_rows.py DIR [DIR ...]  # each checkout in turn
    python3 scripts/layer_kernel_rows.py --rows 1,4,16 [DIR ...]

Each checkout (a directory holding tpullm_torch/) runs in a process of its
own: its kernels are built from its sources, then its build line (kernel
D's registers and spills) and D's rows (Llama-3-8B widths, Q4_K, plain and
folded, M = 4 unless --rows says otherwise) are printed, each against its
plain version and beside the same layer through the port's unfused path,
by chip_smoke.py's own layer_rows (this checkout's chip_smoke.py), so
checkouts given in one call are compared on one card in the order given
(for example: parent, change, change, parent). The last line of each
checkout's output is its rows as JSON.
"""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def one(root: Path, rows) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("layer_kernel_rows: needs a CUDA card")
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    from tpullm_torch.ops import _cuda

    if Path(_cuda.__file__).resolve().parents[2] != root.resolve():
        raise SystemExit(f"layer_kernel_rows: imported {_cuda.__file__}, not {root}'s")
    info = _cuda.build()
    cs.log(f"checkout {root}: {cs.card_line()}; build {info['seconds']:.1f} s; "
           + " ".join(f"{cs.short_kernel(n)}:{r}r/{s}B" for n, r, s in info["ptxas"]
                      if "layer_kernel" in n))
    _cuda.lib()
    timer = cs.Timer(torch)
    entries = []
    for M in rows:
        g = torch.Generator(device="cuda").manual_seed(1234 + M)
        cs.layer_rows(torch, timer, entries, g, M=M)
    print(json.dumps({"checkout": str(root), "rows": entries}), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        one(Path(argv[1]), json.loads(argv[2]))
        return 0
    rows = [4]
    if argv[:1] == ["--rows"]:
        rows = [int(v) for v in argv[1].split(",")]
        argv = argv[2:]
    rc = 0
    for root in argv or [str(HERE)]:
        rc |= subprocess.run([sys.executable, __file__, "--one", root,
                              json.dumps(rows)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
