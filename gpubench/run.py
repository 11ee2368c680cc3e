"""Run one cell of the port's benchmark once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (``sonicscribe_tpu_torch``)
and ``BENCHMARK.json``, on a machine with the cards the cell asks for.
With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy and traced seconds
and a breakdown. Every run checks a sample of what it served against the
plain reference (``reference/``) and prints each number compared beside
its limit, last on standard error and last in the line.

It exits with a code other than 0 and prints no result when the cards are
missing, when the port is not there to import, or when JAX, jaxlib, flax
or the JAX package has been loaded by the time the window has closed.
Build and kernel caches stay in ``build/`` inside the checkout. A run
still going after ``WATCHDOG_S`` seconds prints every thread's stack and
exits with a code other than 0; each stage prints its time on standard
error (``stage <name> +<s> s``).
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WATCHDOG_S = 1150  # under the 1,200 s a checkout's first run may take


def _cache_dirs() -> None:
    """Fixed cache directories inside the checkout, set before torch loads."""
    cache = ROOT / "build" / "gpubench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ.pop("SONIC_KERNEL_DIR", None)  # the port's kernels go to build/kernels
    os.environ["USE_FLAX"] = "0"


def _fail(msg: str, code: int = 3) -> None:
    print(msg, file=sys.stderr, flush=True)
    sys.exit(code)


def device_info(chips: int) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    try:
        line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()
        info["card"] = line[0] if line else None
    except (OSError, subprocess.SubprocessError):
        info["card"] = None
    return info


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

    _cache_dirs()
    sys.path.insert(0, str(ROOT))
    from gpubench import harness, manifest

    cell = manifest.cell(args.workload)
    try:
        import sonicscribe_tpu_torch  # noqa: F401
    except ImportError as e:
        _fail(f"the port is not here to benchmark: {e}")
    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell.chips:
        _fail(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} found")

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                              T_PROCESS, device_info(cell.chips))
    bad = harness.forbidden_modules()
    if bad:
        _fail(f"loaded in the benchmark's process: {', '.join(bad)}", 4)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
