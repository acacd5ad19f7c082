"""Build the CUDA sources in ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

``<hash>`` covers the source, every header in ``csrc/`` and the flags, so an
edited source or header rebuilds at its next use and an unchanged one is
loaded as built. The build runs at first use, in ``build/kernels/`` at the
root of the checkout.
:func:`build` starts one ``nvcc`` per source, all at once. A failed build
raises with nvcc's stderr; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

#: One shared library per source, named after it.
SOURCES: Tuple[str, ...] = (
    "partition_stage1",
    "thomas",
    "partition_stage3",
    "partition_stage1_wide",
    "partition_stage3_wide",
    "ssd_stage1",
    "ssd_stage1_bwd",
    "tridiag_matvec",
)
CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels are built from source at first use"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by a hash of its inputs:
    the source, every header in ``csrc/`` and the flags."""
    h = hashlib.sha256()
    for src in (CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, out: Path) -> Tuple[subprocess.Popen, Path]:
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )
    return proc, tmp


def build(names: Sequence[str] = SOURCES) -> Dict[str, Dict[str, object]]:
    """Build every missing library in ``names`` with one nvcc each, all
    started together. Returns ``{name: {"path", "built", "seconds",
    "ptxas"}}``; ``built`` is False for a library already up to date.
    Raises ``RuntimeError`` with nvcc's stderr when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs: List[Tuple[str, Path, subprocess.Popen, Path]] = []
    info: Dict[str, Dict[str, object]] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            info[name] = {"path": str(out), "built": False, "seconds": 0.0, "ptxas": ""}
            continue
        proc, tmp = _start(name, out)
        jobs.append((name, out, proc, tmp))
    failures: List[str] = []
    for name, out, proc, tmp in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(
                f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
                f"{stderr}{stdout}"
            )
            continue
        os.replace(tmp, out)
        info[name] = {
            "path": str(out),
            "built": True,
            "seconds": time.perf_counter() - t0,
            "ptxas": stderr.strip(),
        }
    if failures:
        raise RuntimeError("\n".join(failures))
    return info


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def entry(name: str, symbol: str, argtypes: Tuple[type, ...]) -> Any:
    """The C entry ``symbol`` of ``csrc/<name>.cu``'s library, its argument
    types set once (an int status return)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
