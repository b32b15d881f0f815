"""Build, load and bind the hand-written CUDA kernels (tpullm_torch/csrc).

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` into an object, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes`` (linked
against the driver library for kernels B and F's TMA descriptors). The build
runs at first use, into ``tpullm_torch/_build/`` keyed by a hash of the
sources and flags, so importing the package never needs ``nvcc``.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on anything but 0.

Arrival counters: kernels D and E find the last block of a tile or a
split group by counters in device memory, which every launch leaves zero.
Two launches in flight on one buffer would race on them, so each owner
that may run beside another (an ``InferenceEngine``, a ``ServerContext``)
makes its own buffers (``own_counters``) and launches inside
``counters_scope``; bare kernel calls use one buffer a device.

Launch counts: every kernel wrapper adds one to ``COUNTS[name]`` where it
launches its kernel, and nowhere else. A CUDA graph's replay runs no
Python, so ``CountedGraph`` takes back the counts its capture added (the
capture launches nothing) and adds them again at every replay.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launches of each hand-written kernel, by wrapper
COUNTS = {"qmm_splitk": 0, "qmm": 0, "flash_attention": 0, "layer_kernel": 0,
          "moe_gmm": 0, "flash_decode": 0, "kv_store": 0, "qmm_experts": 0}

def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


@contextlib.contextmanager
def counts_taken_back(out: dict):
    """Within the block, wrappers count as usual; on leaving it, ``out``
    holds what they added and COUNTS is as it was before the block."""
    before = dict(COUNTS)
    try:
        yield out
    finally:
        out.clear()
        out.update({k: COUNTS[k] - before[k] for k in COUNTS})
        COUNTS.update(before)


def add_counts(delta: dict) -> None:
    for k, n in delta.items():
        COUNTS[k] += n


class CountedGraph:
    """A CUDA graph whose replays count the kernel launches they make: the
    counts of its capture (which launches nothing) are taken back and added
    again at every replay."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.counts: dict = {}

    @contextlib.contextmanager
    def capture(self, stream, pool=None, generators=()):
        """Capture the block on ``stream`` into the graph (a private memory
        pool, or ``pool`` shared with other graphs). Each generator the
        block draws from is registered, so that every replay draws anew
        from its state at that replay."""
        for g in generators:
            self.graph.register_generator_state(g)
        # thread_local: a host read or sync in this thread still breaks the
        # capture (and raises); other threads' CUDA calls (a server's) do not
        with counts_taken_back(self.counts), torch.cuda.graph(
                self.graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
            yield self

    def replay(self) -> None:
        self.graph.replay()
        add_counts(self.counts)


_SCOPE = threading.local()


def own_counters(device, B: int, Hkv: int, S: int, ring: int = 0) -> dict:
    """An owner's arrival counters for kernels D and E, zero, made by an eager
    launch before any capture (a buffer first made inside a capture would
    belong to the graph's pool): {"layer_kernel": D's, "flash_decode": E's,
    sized for B rows, Hkv heads and views of up to S slots, and a ring bank
    of ``ring`` slots where there is one}."""
    from .flash_decode import counters_per_row
    from .layer_kernel import N_COUNTERS

    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("arrival counters would be made during a CUDA graph capture")
    z = lambda n: torch.zeros(n, dtype=torch.int32, device=device)
    return {"layer_kernel": z(N_COUNTERS),
            "flash_decode": z(B * Hkv * max(counters_per_row(S, False),
                                            counters_per_row(S, False, ring)))}


@contextlib.contextmanager
def counters_scope(owned: dict):
    """Within the block, in this thread, kernels D and E launch on the
    counters of ``owned`` (an ``own_counters`` result); a capture in the
    block keeps them."""
    prev = getattr(_SCOPE, "owned", None)
    _SCOPE.owned = owned
    try:
        yield owned
    finally:
        _SCOPE.owned = prev


def scoped_counters(kernel: str):
    """The counters of the current thread's scope for ``kernel``
    ("layer_kernel" or "flash_decode"), or None outside any scope."""
    owned = getattr(_SCOPE, "owned", None)
    return None if owned is None else owned[kernel]


def warm_up_and_capture(step, side, pool, generators=()) -> CountedGraph:
    """Run ``step()`` eagerly on the side stream (a real step: every kernel's
    first use, before any capture), then capture it there into a graph of
    the shared memory pool ``pool``, each generator registered. The side
    stream waits for the caller's stream first, and the caller's stream for
    it after, so the two never overlap. A failed capture raises."""
    main = torch.cuda.current_stream(side.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        step()
    graph = CountedGraph()
    with graph.capture(side, pool, generators=generators):
        step()
    main.wait_stream(side)
    return graph


class GraphOwner:
    """The captured decode steps of one owner (an engine, a server): one
    graph per step key in ``graphs``, all in one memory pool ``pool``,
    warmed up and captured on one side stream, both made at the first
    capture. The owner sets ``device`` and calls ``_init_graphs``."""

    def _init_graphs(self) -> None:
        self.graphs: dict[tuple, CountedGraph] = {}  # by the owner's step key
        self._side = None  # the stream warm-ups and captures run on
        self.pool = None  # the memory pool every graph of the owner shares

    def _capture(self, key, step, generators=()) -> None:
        """``warm_up_and_capture(step)`` as the graph of ``key``."""
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()
        self.graphs[key] = warm_up_and_capture(step, self._side, self.pool, generators)


def resolve_device(device) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU; a
    CUDA device without a card raises (there is no fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (needed to build tpullm_torch/csrc)")


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return h.hexdigest()[:16]


_PTXAS_FN = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_USE = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def _ptxas_summary(text: str) -> list[tuple[str, int, int]]:
    """nvcc -Xptxas -v output -> [(kernel, registers, spill bytes)]."""
    out, fn, spill = [], None, 0
    for line in text.splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            fn, spill = m.group(1), 0
            continue
        m = _PTXAS_SPILL.search(line)
        if m and fn:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = _PTXAS_USE.search(line)
        if m and fn:
            out.append((fn, int(m.group(1)), spill))
            fn = None
    return out


def build() -> dict:
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link the
    shared library unless a build of the same sources exists. Returns
    {"path", "seconds", "ptxas": [(kernel, regs, spill bytes)], "cached"}."""
    lib = BUILD / f"libtpullm_torch_{_digest()}.so"
    info_path = lib.with_suffix(".ptxas.txt")
    if lib.exists():
        text = info_path.read_text() if info_path.exists() else ""
        return {"path": lib, "seconds": 0.0, "ptxas": _ptxas_summary(text),
                "cached": True}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = BUILD / f"{lib.name}.{os.getpid()}.tmp"
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
            *[str(o) for _, o, _ in procs], "-lcudart", "-lcuda"]
    r = subprocess.run(link, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + r.stdout + r.stderr)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    text = "\n".join(logs)
    info_path.write_text(text)
    os.replace(tmp, lib)
    return {"path": lib, "seconds": time.perf_counter() - t0,
            "ptxas": _ptxas_summary(text), "cached": False}


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

_SIGNATURES = {
    # x, M, K, w_ptrs, w_ints, w_floats, part, nS, gps, out, Nout, out_bf16, stream
    "tpq_qmm_splitk": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _I, _I, _P],
    # x, M, K, w_ptrs, w_ints, w_floats, out, Nout, out_bf16, stream
    "tpq_qmm": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _P],
    # x, xs, M, K, w_ptrs, w_ints, w_floats, expert strides, ids, cap, E, part, nS,
    # gps, out, Nout, out_bf16, top_i, wts, used, combine, stream
    "tpq_qmm_experts": [_P, _L, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _P, _I, _I,
                        _P, _P, _I, _I, _P],
    # q k v o qslots kvpos qpos valid_from, B H Hkv T S D,
    # 12 strides, scale softcap window chunked ring, slopes (ALiBi, or null), stream
    "tpq_flash_attention": [_P] * 8 + [_I] * 6 + [_L] * 12 + [_F, _F, _I, _I, _I, _P, _P],
    # w_ptrs(4 pools), w_ints, w_floats, plan, att, res, ffn_norm, anrm_next,
    # out, qkv_out, scratch, counters, M, D, Hd, n_ff, act, fold, nscratch,
    # eps, stream
    "tpq_layer_kernel": [_P] * 4 + [_P] * 8 + [_I] * 6 + [_L, _F, _P],
    # x, Mp, K, w_ptrs, w_ints, w_floats, tile_expert, live, layer, E,
    # slots (the stack's L x E or E weights), out, Nout, stream
    "tpq_moe_gmm": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P],
    # q k v ks vs sinks qslots qpos valid_from (int64) part_ml part_acc counters o,
    # B T H Hkv S NS D q8, 10 strides, scale softcap, window chunked has_sinks ring,
    # slopes (ALiBi, or null), stream
    "tpq_flash_decode": [_P] * 13 + [_I] * 8 + [_L] * 10 + [_F, _F, _I, _I, _I, _I, _P, _P],
    # k v, 6 strides, k_bank v_bank ks vs slot, B T Hkv S Dk Dv b0, in_f32 bank ring, stream
    "tpq_kv_store": [_P, _P] + [_L] * 6 + [_P] * 5 + [_I] * 10 + [_P],
}


@functools.cache
def lib() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, with argtypes set
    for every entry point (pointers and the stream as c_void_p)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a card")
    handle = ctypes.CDLL(str(build()["path"]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.tpq_error_string.argtypes = [_I]
    handle.tpq_error_string.restype = ctypes.c_char_p
    return handle


def check(err: int, what: str) -> None:
    if err != 0:
        msg = lib().tpq_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(t: torch.Tensor, what: str) -> None:
    """Checks a kernel operand: on the card, contiguous, 16-byte aligned."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: data pointer not 16-byte aligned")


_KIND = {"u4": 0, "i8": 1}
_BIAS = {"none": 0, "f32": 1, "i8d": 2}
_KEYS = ("q", "d", "s8", "m8", "dmin", "bm")


def km_descriptor(data: dict, qtype, K: int):
    """One K-major weight (already indexed to its layer) -> the three flat
    arrays the C side turns into a ``KmW``: 6 pointers, 8 ints
    (Npad, K, ds, kind, gs, sb, bias, has_lut), 17 floats (off, lut[16])."""
    from ..quant.kmajor import KM_SPECS

    spec = KM_SPECS.get(qtype)
    if spec is None:
        raise NotImplementedError(
            f"{getattr(qtype, 'name', qtype)}: no K-major layout, so the CUDA "
            "kernels do not take it")
    ptrs = []
    for key in _KEYS:
        t = data.get(key)
        if t is None:
            ptrs.append(0)
            continue
        require_cuda(t, f"weight {key}")
        ptrs.append(t.data_ptr())
    Npad = data["q"].shape[-1]
    ds = K // data["d"].shape[-2]
    ints = [Npad, K, ds, _KIND[spec.kind], spec.gs, 1 if spec.sb else 0,
            _BIAS[spec.bias], 1 if spec.lut else 0]
    floats = [float(spec.off)] + list(spec.lut or (0.0,) * 16)
    return ptrs, ints, floats


def c_km(descs: list) -> tuple:
    """km_descriptor results -> the (pointers, ints, floats) ctypes arrays
    of one or more weights, in order."""
    ptrs = [p for d in descs for p in d[0]]
    ints = [i for d in descs for i in d[1]]
    floats = [f for d in descs for f in d[2]]
    return ((ctypes.c_ulonglong * len(ptrs))(*ptrs),
            (ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(floats))(*floats))
