"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` and loaded with ``ctypes``.
The build runs at first use, from the sources in the package only, into
``build/horovod_tpu_torch/`` at the repository root (ignored by git). A
library's file name carries a hash of its sources and flags, so an edited
source is rebuilt and a stale library is never loaded. ``build_all()``
starts one ``nvcc`` per source, all at once, and waits for them together.
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
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "horovod_tpu_torch"
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# after the source: the tensor-core kernels encode their TMA tensor maps
# with libcuda's cuTensorMapEncodeTiled
LINK_FLAGS = ("-lcuda",)
_NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each library built in
# this process, for chip_smoke.py to print
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the flash-attention kernels "
            "are built from csrc/ at first use on a CUDA machine")
    return found


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> float:
    """Compile every library of ``names`` that is not built yet, one nvcc
    process each, in parallel. Returns the seconds spent; raises with the
    compiler's output if any source fails."""
    t0 = time.perf_counter()
    todo = [(n, _library_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not p.is_file()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for name, path in todo:
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu"), *LINK_FLAGS]
            procs.append((name, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failures = []
        for name, path, tmp, proc in procs:
            out, _ = proc.communicate(timeout=_NVCC_TIMEOUT_S)
            build_logs[name] = out
            if proc.returncode != 0:
                failures.append(f"--- {name} (nvcc rc {proc.returncode})\n"
                                f"{out}")
                continue
            os.replace(tmp, path)  # atomic: a concurrent loader never
            # sees a half-written library
        if failures:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    finally:
        for _, _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building all kernels first
    if this one is missing."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            path = _library_path(name)
            if not path.is_file():
                build_all()
            lib = ctypes.CDLL(str(path))
            lib.hvd_flash_error_string.argtypes = [ctypes.c_int]
            lib.hvd_flash_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]
