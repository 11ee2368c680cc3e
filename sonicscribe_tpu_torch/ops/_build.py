"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with nvcc
for Hopper (``sm_90a``) into ``build/kernels/<name>-<digest>.so`` at the
root of the checkout, on first use, and loaded with ctypes. The digest
covers the source and the flags, so an edited source builds anew and a
stale library is never loaded. ``build()`` starts one nvcc per source, all
at once, and waits for them; ``load()`` builds what is missing.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
KERNELS = ("decode_attention", "log_mel")

# launches per kernel: each wrapper adds one where it launches its kernel
launch_counts: dict[str, int] = {name: 0 for name in KERNELS}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every named kernel whose library is missing, one nvcc each,
    all started together. -> {name: nvcc's -Xptxas=-v report}. Raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp, out,
        )
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
