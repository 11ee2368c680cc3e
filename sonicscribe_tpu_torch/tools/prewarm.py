"""Fill a deploy directory with the prebuilt kernel and native libraries.

The port's counterpart of the JAX package's ``tools/prewarm.py``. JAX
ships serialized executables so that a fresh machine does not compile its
program grid at boot. A CUDA graph cannot be serialized: what a fresh
machine would otherwise build at boot is the kernel libraries (nvcc, one
per ``csrc/*.cu``, ops/_build.py) and the native ring library (g++,
native/__init__.py). This tool puts every one of them into ``--out``
(``kernels/`` and ``native/``), copying a library whose digest the
checkout has already built and building the rest; a server started with
``SONIC_KERNEL_DIR`` pointing at the directory then loads them and builds
nothing. The digest covers the sources and flags, so a library built from
other sources is never loaded: it is built anew, beside the old one.

It then builds the named runtime on that directory and warms it (the
grid's CUDA graphs, which cannot be shipped): the warmup seconds printed
are what a server booting on the directory will still pay.

Usage:
  python -m sonicscribe_tpu_torch.tools.prewarm --model nano-random --out DIR
  python -m sonicscribe_tpu_torch.tools.prewarm --model /ckpt/dir --quant int8 \\
      --out DIR --full
"""

from __future__ import annotations

import argparse
import os
import shutil
import time
from pathlib import Path

from sonicscribe_tpu_torch import native
from sonicscribe_tpu_torch.ops import _build


def _copy(src: Path, dst: Path) -> None:
    dst.parent.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_suffix(f".{os.getpid()}.tmp")
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def stage_libraries(out: str) -> dict:
    """Every kernel library and the native library into the deploy
    directory `out`: present already (same digest) -> kept; built by the
    checkout -> copied; else built there (nvcc / g++). -> {"kept",
    "copied", "built": [file names]}. Sets SONIC_KERNEL_DIR to `out` for
    this process."""
    os.environ[_build.KERNEL_DIR_ENV] = os.path.abspath(out)
    done: dict = {"kept": [], "copied": [], "built": []}
    missing = []
    for name in _build.KERNELS:
        dst = _build.library_path(name)
        src = _build.BUILD_DIR / dst.name
        if dst.exists():
            done["kept"].append(dst.name)
        elif src.exists():
            _copy(src, dst)
            done["copied"].append(dst.name)
        else:
            missing.append(name)
    if missing:
        _build.build(tuple(missing))  # one nvcc each, all at once; raises on a failure
        done["built"] += [_build.library_path(name).name for name in missing]
    dst = native.lib_path()
    src = native.BUILD_DIR / dst.name
    if dst.exists():
        done["kept"].append(dst.name)
    elif src.exists():
        _copy(src, dst)
        done["copied"].append(dst.name)
    elif native.build() is not None:
        done["built"].append(dst.name)
    else:
        raise RuntimeError("the native library could not be built (g++ or its source missing)")
    return done


def build_engine(model: str, vad: str, quant: str, shape: str, device: str):
    """-> (engine, info): the serve default's runtime in `quant`, or the
    engine of the benches' 50-stream (bench-stream) or 16-segment file
    (bench-file) shape, native as in the JAX tool."""
    from sonicscribe_tpu_torch.config import AppConfig
    from sonicscribe_tpu_torch.serve.runtime import build_runtime
    from sonicscribe_tpu_torch.tools.loadtest import bench_engine

    if shape == "server":
        cfg = AppConfig()
        cfg.quant_mode = quant
        engine, _vad, info = build_runtime(model, vad, cfg, device=device)
        return engine, info
    quick = model == "tiny-random"
    if shape == "bench-stream":
        engine = bench_engine(quick, device, vad="probe", slots=32, max_decode_tokens=200,
                              buckets=(128, 512))
    else:
        engine = bench_engine(quick, device, vad="probe", slots=16, max_decode_tokens=256,
                              buckets=(2048,), fuse_dual_decode=False)
    return engine, {}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="nano-random",
                   help="'tiny-random' | 'nano-random' | checkpoint dir")
    p.add_argument("--vad", default="energy", help="'energy' | 'silero' | weights path")
    p.add_argument("--quant", default="native",
                   choices=("native", "int8", "int8-decoder", "int8-decoder-a8"))
    p.add_argument("--out", required=True, help="deploy directory to create/extend")
    p.add_argument("--full", action="store_true",
                   help="warm the full (bucket, B) prefill grid")
    p.add_argument("--engine-shape", default="server",
                   choices=("server", "bench-stream", "bench-file"),
                   help="which engine construction to mirror: the serve default, the "
                        "benches' 50-stream engine, or their 16-segment file engine")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    out = os.path.abspath(args.out)
    loaded0 = _build.library_counts["loaded"] + native.library_counts["loaded"]
    staged = stage_libraries(out)
    saves = len(staged["copied"]) + len(staged["built"])

    t0 = time.perf_counter()
    engine, _info = build_engine(args.model, args.vad, args.quant, args.engine_shape,
                                 args.device)
    build_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    try:
        engine.warmup(full=args.full)
    finally:
        engine.shutdown()
    warm_s = time.perf_counter() - t1
    loads = _build.library_counts["loaded"] + native.library_counts["loaded"] - loaded0

    n_files = sum(len(files) for _, _, files in os.walk(out))
    print(f"prewarm done: model={args.model} quant={args.quant} shape={args.engine_shape} "
          f"build={build_s:.1f}s warmup={warm_s:.1f}s saves={saves} loads={loads} "
          f"store_files={n_files} -> {out}", flush=True)
    print("deploy: ship this directory with the checkpoint and start the server with "
          "SONIC_KERNEL_DIR pointing at it", flush=True)


if __name__ == "__main__":
    main()
