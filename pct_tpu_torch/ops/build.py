"""Build the port's CUDA sources (``csrc/*.cu``) with nvcc for ``sm_90a``.

Each source compiles on its own into a shared library with a plain C
interface, loaded with ``ctypes``. Builds happen at first use, from the
sources in the package only, into ``_build/`` beside them (git-ignored).
A library's file name carries a hash of its source, of every shared
header (``csrc/*.cuh``) and of the flags, so an edited source or header
is rebuilt and never loaded stale. A missing ``nvcc`` or a failed build
raises.

Every kernel launch goes through ``kernel(source, symbol)``: the
libraries share one C ABI (device pointers, then ints, then the
``cudaStream_t``; the entry point returns ``cudaGetLastError()``), so
one launcher converts the operands, checks them, launches on the
operands' device and current stream, raises on a CUDA error and counts
the launch as ``launches.<symbol>`` in ``utils.trace.counters()``.
Host queries that launch nothing (a layout, an occupancy) call
``load(name)`` with their own types.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import operator
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from pct_tpu_torch.utils import trace

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under $CUDA_HOME or
    /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(Path(root) / "bin" / "nvcc", os.X_OK):
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: keyed on the
    source, every ``csrc/*.cuh`` header (any of them may be included) and
    the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile each named source (default: every ``csrc/*.cu``) that is
    not built yet, one nvcc process per source, all started together.
    Returns {name: library path}; nvcc's output (register and spill
    counts from ``-Xptxas=-v``) and its wall seconds are kept beside each
    library as ``.log``.
    """
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    libs = {name: library_path(name) for name in names}
    todo = {name: lib for name, lib in libs.items() if not lib.exists()}
    if not todo:
        return libs
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = open(lib.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, log, time.perf_counter())
    errors = []
    while procs:
        for name, (proc, tmp, log, t0) in list(procs.items()):
            if proc.poll() is None:
                continue
            del procs[name]
            log.write(f"nvcc {name}.cu: {time.perf_counter() - t0:.2f} s\n")
            log.close()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                errors.append(f"{name}.cu: nvcc exited {proc.returncode}\n"
                              f"{todo[name].with_suffix('.log').read_text()}")
            else:
                os.replace(tmp, todo[name])
        time.sleep(0.02)
    if errors:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(errors))
    return libs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first call)."""
    return ctypes.CDLL(str(build_all([name])[name]))


def stream(dev: torch.device) -> int:
    """The handle of ``dev``'s current CUDA stream."""
    return torch.cuda.current_stream(dev).cuda_stream


@functools.cache
def _entry(source: str, symbol: str):
    fn = getattr(load(source), symbol)
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def kernel(source: str, symbol: str):
    """The launcher of entry point ``symbol`` of ``csrc/<source>.cu``.

    ``launch(*operands)`` passes each tensor as its data pointer, None as
    a null pointer and each int as a 32-bit int, then the current stream
    of the tensors' device. Before any library is loaded it raises
    ``ValueError`` for an int outside [-2^31, 2^31), a tensor that is
    not contiguous, tensors on several devices or none, and a device
    that is not CUDA. A nonzero CUDA error raises ``RuntimeError``; each
    launch adds 1 to counter ``launches.<symbol>``.
    """
    counter = "launches." + symbol

    def launch(*operands):
        devs = set()
        for i, a in enumerate(operands):
            if isinstance(a, torch.Tensor):
                devs.add(a.device)
                if not a.is_contiguous():
                    raise ValueError(f"{symbol} operand {i} must be "
                                     "contiguous")
            elif a is not None and not -2**31 <= operator.index(a) < 2**31:
                raise ValueError(f"{symbol} operand {i} = {a} is not a "
                                 "32-bit int")
        if len(devs) != 1:
            raise ValueError(f"{symbol} operands on {len(devs)} devices: "
                             f"{sorted(map(str, devs))}")
        (dev,) = devs
        if dev.type != "cuda":
            raise ValueError(f"no {source} kernel for device {dev}")
        args = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
                else ctypes.c_void_p() if a is None
                else ctypes.c_int(operator.index(a)) for a in operands]
        fn = _entry(source, symbol)
        with torch.cuda.device(dev):
            err = fn(*args, ctypes.c_void_p(stream(dev)))
        if err != 0:
            raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
        trace.count(counter, 1)

    return launch
