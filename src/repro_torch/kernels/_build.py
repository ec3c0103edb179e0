"""Build and load the port's CUDA kernels (``kernels/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers:
a file builds in seconds). Libraries go to ``build/repro_torch/`` at the
repository root, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds
and an unchanged one is reused. Nothing is built
when this module is imported: ``load(name)`` builds at first use, and
``build_all()`` starts one ``nvcc`` per source, all together."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("fused_expand", "merge_sorted", "dist_h", "dist_l",
           "pq_adc_expand", "ksort_l", "fused_filter", "flash_attention",
           "decode_attention", "trip_fold")

# loaded libraries by source name; filled only by load()/build_all()
_LIBS: Dict[str, ctypes.CDLL] = {}


def loaded() -> List[str]:
    """Names of the kernel libraries this process has built or loaded."""
    return sorted(_LIBS)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [Path(CUDA_HOME) / "bin" / "nvcc"] if CUDA_HOME else []
    for c in cand:
        if c.exists():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "build only where the CUDA toolkit is installed")
    return found


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src.read_bytes() + headers
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{h}.so"


def _start(name: str):
    """Start nvcc for one source if its library is missing; returns the
    running process (or None) and the library path."""
    src, lib = _target(name)
    if lib.exists():
        return None, lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp = tmp
    return proc, lib


def _finish(name: str, proc, lib: Path) -> str:
    log = ""
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(proc.tmp, lib)
        lib.with_suffix(".log").write_text(log)
    _LIBS[name] = ctypes.CDLL(str(lib))
    return log


def build_all() -> Dict[str, dict]:
    """Build (or reuse) and load every kernel library, one nvcc process
    per source, all started together. Returns per-source
    {"seconds", "built", "ptxas"} (ptxas's register, shared-memory and
    spill report when the source was compiled in this call)."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in SOURCES if n not in _LIBS}
    out = {}
    for name, (proc, lib) in started.items():
        log = _finish(name, proc, lib)
        out[name] = {"seconds": time.perf_counter() - t0,
                     "built": proc is not None,
                     "ptxas": [ln.strip() for ln in log.splitlines()
                               if "ptxas info" in ln or "spill" in ln]}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it on first use."""
    if name not in _LIBS:
        _finish(name, *_start(name))
    return _LIBS[name]


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error code other than 0."""
    if err != 0:
        fn = getattr(lib, f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({fn(err).decode()})")
