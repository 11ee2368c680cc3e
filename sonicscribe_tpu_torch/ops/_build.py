"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with nvcc
for Hopper (``sm_90a``) into ``build/kernels/<name>-<digest>.so`` at the
root of the checkout, on first use, and loaded with ctypes. The digest
covers the source, every header of ``csrc/`` it includes (``#include
"x.cuh"``, followed through the headers' own includes) and the flags, so
an edited source or header builds anew and a stale library is never
loaded. ``build()`` starts one nvcc per source, all
at once, and waits for them; ``load()`` builds what is missing.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
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
KERNELS = ("decode_attention", "log_mel", "int8_matmul", "int4_matmul")  # csrc/<name>.cu

# launches per wrapper: each adds one where it launches its kernel
launch_counts: dict[str, int] = {
    name: 0 for name in (
        "decode_attention", "verify_attention", "log_mel",
        "int8_matmul", "int8_matmul_stacked", "int8_matmul_w8a8",  # csrc/int8_matmul.cu
        "int8_matmul_mma",  # the flat launches that took the tensor-core design
        "int8_matmul_w8a8_mma",  # the W8A8 launches on the s8 tensor cores
        "int4_matmul", "int4_matmul_stacked",  # csrc/int4_matmul.cu
        "int4_matmul_w4a16_mma",  # the W4A16 launches (flat and stacked) on the tensor cores
        "int4_matmul_w4a8", "int4_matmul_w4a8_stacked",
        "int4_matmul_w4a8_mma",  # the W4A8 launches (flat and stacked) on the tensor cores
    )
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


@functools.cache
def n_sms(device) -> int:
    """Streaming multiprocessors of a CUDA device (launch shapes fill them)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """csrc/<name>.cu and every csrc/ header it includes, directly or
    through another header, each once, in the order first reached."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())]
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


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
