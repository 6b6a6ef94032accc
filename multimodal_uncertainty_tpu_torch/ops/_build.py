"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, at first use, into a shared library with a
plain C interface under ``csrc/build/`` (listed in ``.gitignore``). The file
name carries a hash of the source, the ``csrc/*.cuh`` headers and the flags,
so an edited source or header is rebuilt and a stale library is never
loaded. The attention kernels' instances are split over several sources (one
header, one ``.cu`` per group of head dims) so that their builds run side by
side. Nothing is built or imported
from CUDA when this module is imported: the CPU tests import every module.
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

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "build"
SOURCES = ("attention_fwd_256", "attention_fwd_wide",
           "attention_fwd_tc", "attention_fwd_tc_24", "attention_fwd_tc_32",
           "attention_fwd_tc_48", "attention_fwd_tc_k6", "attention_fwd_tc_128",
           "attention_fwd_tc_192", "attention_fwd_tc_256",
           "attention_fwd_tc_384", "attention_fwd_tc_768",
           "attention_fwd_tc32", "attention_fwd_tc32_k6",
           "attention_bwd", "attention_bwd_k6", "attention_bwd_256", "attention_bwd_wide",
           "attention_bwd_tc", "attention_bwd_tc_24", "attention_bwd_tc_32",
           "attention_bwd_tc_48", "attention_bwd_tc_k6", "attention_bwd_tc_128",
           "attention_bwd_tc_192", "attention_bwd_tc_256",
           "attention_bwd_tc_384", "attention_bwd_tc_768",
           "dw", "layer_norm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels build from csrc/ at first use"
    )


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every missing library of ``names``, one nvcc each, all started
    together. Returns the seconds each build took (0 for a library already
    built). The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        jobs[name] = (proc, out, tmp, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, out, tmp, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
