"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at
first use with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``
into ``spark_sklearn_tpu_torch/_build/`` (listed in ``.gitignore``), under
a name keyed by the source's and flags' digest, then loaded with
``ctypes``.  Nothing is built at import time: the CPU tests import every
module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.insert(0, os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out


def build(names: Sequence[str]) -> Dict[str, Dict[str, object]]:
    """Compile every named source that is not built yet, one ``nvcc``
    per source, all started together.  Returns, per name, the build's
    seconds (0.0 when it was already built) and nvcc's output (ptxas'
    register and spill report)."""
    t0 = time.perf_counter()
    running = {}
    report: Dict[str, Dict[str, object]] = {}
    for name in names:
        if library_path(name).exists():
            report[name] = {"seconds": 0.0, "log": ""}
        else:
            running[name] = _start(name)
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)      # atomic: a reader never sees half a file
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built first if needed).
    Cached: one ``CDLL`` per process."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
