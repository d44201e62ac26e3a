"""Build the port's CUDA sources (``csrc/*.cu``) with nvcc for ``sm_90a``.

Each source compiles on its own into a shared library with a plain C
interface, loaded with ``ctypes``. Builds happen at first use, from the
sources in the package only, into ``_build/`` beside them (git-ignored).
A library's file name carries a hash of its source, of every shared
header (``csrc/*.cuh``) and of the flags, so an edited source or header
is rebuilt and never loaded stale. A missing ``nvcc`` or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

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
