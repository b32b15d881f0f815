#!/usr/bin/env python3
"""Kernel E's rows of chip_smoke.py's phase 2, on one NVIDIA H100, for one
checkout's tpullm_torch or for several in turns.

    python3 scripts/flash_decode_rows.py                # this checkout
    python3 scripts/flash_decode_rows.py DIR [DIR ...]  # each checkout in turn

Each checkout (a directory holding tpullm_torch/) runs in a process of its
own: its kernels are built from its sources, then its build line (kernel
E's registers and spills) and E's rows (the server's decode shape on bf16
and int8 K/V, the engine's on bf16, and phase 11's two Gemma-2-9B rows at
head dim 256 with softcap 50 and window 4096: ms, the device ms of the main
and merge launches apart, the bound, the library call and the einsum path,
a digest of the output bits) are printed by this checkout's chip_smoke.py
(decode_rows, decode_row), so
checkouts given in one call are compared on one card in the order given
(for example: parent, change, change, parent).

Where a checkout's library also exports ``tpq_flash_decode_stamps(dst, n)``
(an instrumented build whose kernel stamps ``globaltimer`` into a device
buffer, 8 values a block in grid order: by default setup ns, then the
summed ns of the tile loads, the score pass, the softmax pass and the PV
pass over its tiles, the partial store's ns, the block's end stamp and its
tile count; a build may name the first 7 otherwise through
``tpq_flash_decode_stamp_fields()``, a comma-separated string, a field
named "end" or "t_..." being a time stamp, 0 where a block left none, and
field 0 the block's start), one more launch at the server's shape on
each K/V type is read back and the median and largest value of each field
over the blocks that read a tile are printed (time stamps as their range
after the first block's start). The last line of each checkout's output is
its rows as JSON.
"""
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
STAMP_FIELDS = ("setup", "loads", "scores", "softmax", "pv", "store", "end")


def stamps(torch, cs, lib) -> dict:
    """Per-phase medians (us) over the working blocks of one launch at the
    server's shape, bf16 and int8, from an instrumented build's stamps."""
    from tpullm_torch.models.config import ModelConfig
    from tpullm_torch.ops import flash_decode as fd
    from tpullm_torch.ops.flash_decode import flash_decode

    lib.tpq_flash_decode_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tpq_flash_decode_stamps.restype = ctypes.c_int
    fields = STAMP_FIELDS
    if hasattr(lib, "tpq_flash_decode_stamp_fields"):
        lib.tpq_flash_decode_stamp_fields.restype = ctypes.c_char_p
        fields = tuple(lib.tpq_flash_decode_stamp_fields().decode().split(","))
    cfg = ModelConfig(n_head=cs.H, n_head_kv=cs.HKV, head_dim=cs.HD, head_dim_v=cs.HD)
    g = torch.Generator(device="cuda").manual_seed(99)
    out = {}
    for q8 in (False, True):
        slots = [6000, 2000, 700, 40]
        S, B = 8192, len(slots)
        q, k, v, ks, vs, qs, pos, vf = cs.decode_operands(torch, g, B, 1, cs.H, cs.HKV, S,
                                                          cs.HD, slots, q8)
        flash_decode(q, k, v, qs, pos, vf, cfg, k_scales=ks, v_scales=vs)
        torch.cuda.synchronize()
        n = -(-S // fd.E_CH[q8]) * cs.HKV * B * 8
        buf = (ctypes.c_ulonglong * n)()
        if lib.tpq_flash_decode_stamps(ctypes.addressof(buf), n) != 0:
            raise SystemExit("flash_decode_rows: reading the stamps failed")
        blocks = [list(buf[i: i + 8]) for i in range(0, n, 8)]
        work = [b for b in blocks if b[7] > 0]
        med, top, spread = {}, {}, {}
        t0 = min(b[0] for b in work)
        for f, name in enumerate(fields):
            vals = sorted(b[f] for b in work)
            if name == "end" or name.startswith("t_"):
                vals = [v for v in vals if v]  # 0: not stamped in that block
                spread[name] = ((vals[0] - t0) / 1e3, (vals[-1] - t0) / 1e3)
                continue
            med[name], top[name] = vals[len(vals) // 2] / 1e3, vals[-1] / 1e3
        # blocks that read no tile but left a stamp (field 0 its start, field 1
        # its duration): the splits with no visible slot
        idle = [b for b in blocks if b[7] == 0 and b[1] > 0]
        if idle and fields[0].startswith("t_"):
            t0 = min(b[0] for b in work)
            dur = sorted(b[1] for b in idle)
            cs.log(f"stamps {'int8' if q8 else 'bf16'}: {len(idle)} blocks read no tile; us each, "
                   f"median {dur[len(dur) // 2] / 1e3:.2f} (largest {dur[-1] / 1e3:.2f}); they start "
                   f"{(min(b[0] for b in idle) - t0) / 1e3:.1f}-{(max(b[0] for b in idle) - t0) / 1e3:.1f}"
                   " us after the first block that reads one")
        key = "int8" if q8 else "bf16"
        out[key] = dict(median_us=med, max_us=top, working_blocks=len(work),
                        tiles_median=sorted(b[7] for b in work)[len(work) // 2],
                        end_spread_us=spread)
        cs.log(f"stamps {key}: {len(work)} working blocks; us a block, median (largest) "
               + " ".join(f"{k} {v:.2f} ({top[k]:.2f})" for k, v in med.items())
               + "".join(f"; {k} {a:.1f}-{b:.1f} us after the first start"
                         for k, (a, b) in spread.items()))
        del q, k, v, ks, vs
    return out


def one(root: Path) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flash_decode_rows: needs a CUDA card")
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    from tpullm_torch.ops import _cuda

    if Path(_cuda.__file__).resolve().parents[2] != root.resolve():
        raise SystemExit(f"flash_decode_rows: imported {_cuda.__file__}, not {root}'s")
    info = _cuda.build()
    cs.log(f"checkout {root}: {cs.card_line()}; build {info['seconds']:.1f} s; "
           + " ".join(f"{cs.short_kernel(n)}:{r}r/{s}B" for n, r, s in info["ptxas"]
                      if "flash_decode" in n))
    lib = _cuda.lib()
    timer = cs.Timer(torch)
    entries = []
    g = cs.decode_rows(torch, timer, entries)
    gm = cs.GEMMA2
    heads, hd = (gm["n_head"], gm["n_head_kv"]), gm["head_dim"]
    cs.decode_row(torch, timer, entries, g, "Gemma-2-9B server", 8192, [6000, 2000, 700, 40],
                  [0, 0, 0, 0], True, heads=heads, hd=hd, softcap=50.0, window=4096)
    cs.decode_row(torch, timer, entries, g, "Gemma-2-9B engine", 1024, [527] * 4,
                  [0, 212, 312, 412], False, heads=heads, hd=hd, softcap=50.0, window=4096)
    result = {"checkout": str(root), "rows": entries}
    if hasattr(lib, "tpq_flash_decode_stamps"):
        result["stamps"] = stamps(torch, cs, lib)
    print(json.dumps(result), flush=True)


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
