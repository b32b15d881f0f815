#!/usr/bin/env python3
"""Kernel C's head-dim-128 rows of chip_smoke.py's phase 2, on one NVIDIA
H100, for one checkout's tpullm_torch or for several in turns.

    python3 scripts/flash_attention_rows.py                # this checkout
    python3 scripts/flash_attention_rows.py DIR [DIR ...]  # each checkout in turn

Each checkout (a directory holding tpullm_torch/) runs in a process of its
own: its kernels are built from its sources, then its build line (kernel
C's registers and spills) and C's rows at Llama-3-8B's heads (the engine's
prefill, B4 T512 S1024, and the server's last chunk of a 6000-token
prompt, B1 T512 at slots 5632+ over 8192: ms, the bound, the plain
version and SDPA) are printed by this file's chip_smoke.py (attn_row),
``--repeats`` times over (3 by default), so checkouts given in one call are
compared on one card in the order given (for example: parent, change,
change, parent), and each checkout's spread shows the noise of a row. The
last line of each checkout's output is its rows as JSON.
"""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def one(root: Path, repeats: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flash_attention_rows: needs a CUDA card")
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from tpullm_torch.ops import _cuda

    if Path(_cuda.__file__).resolve().parents[2] != root.resolve():
        raise SystemExit(f"flash_attention_rows: imported {_cuda.__file__}, not {root}'s")
    info = _cuda.build()
    cs.log(f"checkout {root}: {cs.card_line()}; build {info['seconds']:.1f} s; "
           + " ".join(f"{cs.short_kernel(n)}:{r}r/{s}B" for n, r, s in info["ptxas"]
                      if "flash_kernel" in n))
    timer = cs.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(17)
    entries = []
    for _ in range(repeats):
        cs.attn_row(torch, timer, entries, g, B=4, T=512, S=1024, n_past=0,
                    vf=[0, 212, 312, 412])
        cs.attn_row(torch, timer, entries, g, B=1, T=512, S=8192, n_past=5632, vf=[0],
                    path="8B server")
    ms = {}
    for e in entries:
        ms.setdefault(e["name"], []).append(e["ms"])
    for name, ts in ms.items():
        cs.log(f"checkout {root}: {name} ms {' '.join(f'{t:.4f}' for t in ts)} "
               f"(spread {(max(ts) - min(ts)) / min(ts):.1%})")
    print(json.dumps({"checkout": str(root), "ms": ms, "rows": entries}), flush=True)


def main(argv) -> int:
    repeats = 3
    if argv[:1] == ["--repeats"]:
        repeats, argv = int(argv[1]), argv[2:]
    if argv[:1] == ["--one"]:
        one(Path(argv[1]), repeats)
        return 0
    rc = 0
    for root in argv or [str(HERE)]:
        rc |= subprocess.run([sys.executable, __file__, "--repeats", str(repeats), "--one",
                              root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
