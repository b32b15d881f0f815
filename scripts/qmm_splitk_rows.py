#!/usr/bin/env python3
"""Kernel A's rows of chip_smoke.py's phase 2, on one NVIDIA H100, for one
checkout's tpullm_torch or for several in turns.

    python3 scripts/qmm_splitk_rows.py                # this checkout
    python3 scripts/qmm_splitk_rows.py DIR [DIR ...]  # each checkout in turn

Each checkout (a directory holding tpullm_torch/) runs in a process of its
own: its kernels are built from its sources, then chip_smoke.py's build
line (registers, spills, kernel A's SASS instructions per weight) and A's
rows (the eight at Llama-3-8B's weights, M = 4, and gateup at M = 32; the
two Mixtral experts and the Mixtral lm_head at M = 4) are printed, each
against its plain version, with the kernel's ms, the device ms of
qmm_splitk_kernel and qmm_reduce apart, the bound and the cuBLAS time.
The rows are chip_smoke.py's own functions (this checkout's), so two
checkouts given in one call are compared on one card, in the order given
(for example: parent, change, change, parent). The last line of each
checkout's output is its rows as JSON.
"""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def one(root: Path) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("qmm_splitk_rows: needs a CUDA card")
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    from tpullm_torch.ops import _cuda

    if Path(_cuda.__file__).resolve().parents[2] != root.resolve():
        raise SystemExit(f"qmm_splitk_rows: imported {_cuda.__file__}, not {root}'s")
    info = _cuda.build()
    cs.log(f"checkout {root}: {cs.card_line()}; build {info['seconds']:.1f} s; "
           + " ".join(f"{cs.short_kernel(n)}:{r}r/{s}B" for n, r, s in info["ptxas"]
                      if "qmm_splitk" in n or "qmm_reduce" in n))
    cs.log("kernel A SASS (loop instructions, of them on branches, weights a thread, per "
           "weight off the branches): " + " ".join(
               f"{k}:{n}/{c}/{w}/{r:.2f}" for k, (n, c, w, r)
               in cs.sass_per_weight(info["path"]).items()))
    _cuda.lib()
    timer = cs.Timer(torch)
    entries = []
    cs.matmul_rows(torch, timer, entries, kernels=("qmm_splitk",))
    cs.moe_matmul_rows(torch, timer, entries, kernels=("qmm_splitk",))
    for e in entries:
        e.pop("kernel", None)
    print(json.dumps({"checkout": str(root), "rows": entries}), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        one(Path(argv[1]))
        return 0
    rc = 0
    for root in argv or [str(HERE)]:
        rc |= subprocess.run([sys.executable, __file__, "--one", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
