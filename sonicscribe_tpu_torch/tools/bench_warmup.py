"""Warmup A/B on the card: a cold boot against a restart on prebuilt libraries.

The port's twin of the JAX package's ``tools/bench_warmup.py``. There the
cold boot compiles the program grid and the restart deserializes it from
the executable store. Here a CUDA graph cannot be serialized, so what a
restart can skip is the build of the kernel libraries (nvcc) and the
native library (g++): the prebuilt-library deploy path of
``tools/prewarm.py`` (``SONIC_KERNEL_DIR``).

Each mode runs in a fresh subprocess against one library directory:

- ``fast``: the directory empty, so every library the boot needs is built
  with nvcc, then the two-phase boot (``warmup(fast=True)``);
- ``restart``: the same directory, so nothing is built, then the same
  fast boot. ``saves`` counts libraries built, ``loads`` those loaded
  prebuilt (> 0 and saves 0: the directory served the restart).

Both then capture the deferred grid (``warmup_join``) and drain the
replay queue, as in JAX. The engine is the JAX bench's: nano bf16 from
seed 0 (``--quick``: tiny f32), buckets 128 / 512, 32 long slots, 200
decode tokens, the Silero cost probe.

Run on the card:  python -m sonicscribe_tpu_torch.tools.bench_warmup
It prints one JSON line and writes a file only with ``--out``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from sonicscribe_tpu_torch.tools.loadtest import bench_parser, device_fields, emit

ROOT = Path(__file__).resolve().parents[2]  # the checkout the children import from

_CHILD = r'''
import json, os, sys, time
os.environ["SONIC_KERNEL_DIR"] = sys.argv[2]
from sonicscribe_tpu_torch import native
from sonicscribe_tpu_torch.ops import _build
from sonicscribe_tpu_torch.tools.loadtest import bench_engine

mode, quick, device = sys.argv[1], sys.argv[3] == "1", sys.argv[4]
eng = bench_engine(quick, device, vad="probe", slots=32, max_decode_tokens=200,
                   buckets=(128, 512), no_eos=False, no_pad=False)
native.load()  # the sessions' ring library, which a server loads at its first stream
t0 = time.perf_counter()
eng.warmup(fast=True)
ready = time.perf_counter() - t0
eng.warmup_join()
joined = time.perf_counter() - t0
drain_s = eng.drain_replays()
total = time.perf_counter() - t0
counts = {k: _build.library_counts[k] + native.library_counts[k] for k in ("built", "loaded")}
print(json.dumps({"mode": mode, "ready_s": ready, "with_background_s": joined,
                  "replay_drain_s": drain_s, "steady_state_s": total,
                  "saves": counts["built"], "loads": counts["loaded"],
                  "phase_s": eng.stats.get("warmup_phase_s", {})}))
eng.shutdown()
'''

NOTE = ("fast: two-phase cold boot on an EMPTY library directory, so nvcc builds each "
        "kernel library the boot needs and g++ the native one (ready_s = boot-to-serving; "
        "with_background_s adds the deferred B>1/rows/verify grid; replay_drain_s is the "
        "replay queue drained to steady state, which serving pays one capture per idle "
        "tick). restart: the SAME fast boot on the directory the first run filled, the "
        "shipped path (tools/prewarm.py + SONIC_KERNEL_DIR); saves counts libraries built, "
        "loads those loaded prebuilt. CUDA graphs cannot be serialized, so both modes "
        "capture the grid anew.")


def bench(quick: bool, device: str, timeout_s: float = 3600.0) -> dict:
    """Run both modes, each in its own process, on one library directory
    made empty for the first. -> the JSON (device fields, note, a dict per
    mode; a mode that printed no JSON holds its stderr's tail)."""
    work = tempfile.mkdtemp(prefix="bench_warmup_")
    out: dict = {}
    try:
        for mode in ("fast", "restart"):
            r = subprocess.run(
                [sys.executable, "-u", "-c", _CHILD, mode, os.path.join(work, "lib"),
                 "1" if quick else "0", device],
                capture_output=True, text=True, timeout=timeout_s, cwd=ROOT)
            lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
            out[mode] = json.loads(lines[-1]) if lines else {"error": r.stderr[-800:]}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"bench": "warmup", "model": "tiny" if quick else "nano", **device_fields(device),
            "note": NOTE, **out}


def main(argv=None) -> None:
    args = bench_parser(__doc__).parse_args(argv)
    emit(bench(args.quick, args.device), args.out)


if __name__ == "__main__":
    main()
