"""Build a kernel source with ``nvcc`` into a shared library at first use.

Each ``csrc/*.cu`` file exposes a plain C interface and is loaded with
``ctypes``; the headers they share live in ``kernels/csrc/``. The library
goes into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source, the shared headers and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused. There is no fallback: without ``nvcc`` the build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
INCLUDE_DIR = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(INCLUDE_DIR))

_lock = threading.Lock()
_loaded: dict = {}      # library path -> ctypes.CDLL, one load per process


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): "
                           "the CUDA kernels are built on the machine with "
                           "the card")
    return found


def build(source: Path) -> tuple[Path, str, float]:
    """Compile ``source`` unless an up-to-date library exists. Returns the
    library path, the compiler's ``-Xptxas -v`` report and the seconds the
    build took (0.0 when the library was already there)."""
    source = Path(source)
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(INCLUDE_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS[:-1]).encode())   # not the checkout's path
    digest = h.hexdigest()[:16]
    lib = BUILD_DIR / f"{source.stem}-{digest}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    r = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                       capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"(exit {r.returncode}):\n{r.stdout}\n{r.stderr}")
    report = r.stdout + r.stderr
    log.write_text(report)
    os.replace(tmp, lib)        # atomic: a concurrent loader never sees half
    return lib, report, seconds


def load(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load ``source``'s library once per process."""
    with _lock:
        lib_path, _, _ = build(source)
        key = str(lib_path)
        if key not in _loaded:
            _loaded[key] = ctypes.CDLL(key)
        return _loaded[key]
