"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Every ``csrc/<name>.cu`` compiles on its own into ``build/<name>-<hash>.so``,
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  The hash covers the source, every ``.cuh`` beside it and the
flags, so an edited kernel rebuilds and an unchanged one is reused.  Builds
start at first use, never at import: the CPU tests import every module on a
machine with no ``nvcc``.  :func:`build_all` starts one ``nvcc`` per source,
all together, and waits for them.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-lineinfo",
)

_libraries: Dict[str, ctypes.CDLL] = {}
# what the last build in this process reported, per source name
build_seconds: Dict[str, float] = {}
build_reports: Dict[str, str] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises when none has it."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the port's CUDA kernels are built from tpu_parallel_torch/csrc at first use"
    )


def sources() -> Dict[str, Path]:
    """``{name: path}`` of every kernel source in ``csrc/``."""
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def library_path(name: str) -> Path:
    src = sources()[name]
    digest = hashlib.sha256()
    for part in [src, *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(part.name.encode())
        digest.update(part.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build the named sources (default: all) that are not built yet, one
    ``nvcc`` process per source, all started together.  Returns
    ``{name: library path}``; raises ``RuntimeError`` with the compiler's
    output when a build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    unknown = [n for n in names if n not in srcs]
    if unknown:
        raise KeyError(f"no kernel source for {unknown} in {CSRC_DIR}")
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for n in todo:
        # compile to a private name, then rename: a process that finds the
        # final path never sees a half-written library
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(srcs[n])]
        procs[n] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failures = []
    for n, (tmp, start, proc) in procs.items():
        output, _ = proc.communicate()
        build_seconds[n] = time.perf_counter() - start
        # ptxas -v: registers, shared memory, and the stack/spill line that
        # follows each kernel's "Function properties" line
        build_reports[n] = "\n".join(
            line for line in output.splitlines() if "ptxas" in line or "spill" in line
        )
        if proc.returncode != 0:
            failures.append(f"--- nvcc {srcs[n].name} (exit {proc.returncode})\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it on first use."""
    lib = _libraries.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _libraries[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if code != 0:
        message = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({message})")
