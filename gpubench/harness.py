"""One run of one cell: set-up, the measured window, the readings, the check.

``run_cell`` builds the system from the cell's configuration, its model
family (``families/<family>.py``) and the seed, drives the cell's traffic
(``traffic/<kind>.py``), which opens and closes the window through the
``Window`` it is given, and then, in this order: reads the device's memory
peak; reads the cell's metrics (``metrics/<name>.py``; a kernel's roofline
times its probe, ``probes.py``, on the card in the traced run); frees the
program; judges a sample of what the program served against the family's
reference (``reference/check.py``). The result is the line the benchmark
prints.
"""

from __future__ import annotations

import asyncio
import gc
import json
import math
import sys
import threading
import time

import numpy as np

from gpubench import manifest, system
from gpubench.reference import check, frontend
from gpubench.trace import DeviceTrace, Spans

FORBIDDEN = ("jax", "jaxlib", "flax", "sonicscribe_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _routers(engine) -> list:
    out = []
    for eng in list(getattr(engine, "replicas", None) or [engine]):
        for r in (getattr(eng, "router", None), getattr(eng.transcriber, "router", None)):
            if r is not None and all(r is not o for o in out):
                out.append(r)
    return out


def _engines(engine) -> list:
    return list(getattr(engine, "replicas", None) or [engine])


class Window:
    """What the traffic is handed: the system, the mix, the clock of the
    window and the trace."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, engine, vad, conf):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.mix = cell.mix
        self.program = engine
        self.engine = system.Recorder(engine)
        self.vad, self.conf = vad, conf
        self.spans = Spans()
        self.trace_s = cell.workload["trace_s"] if trace else None
        self.device_trace = DeviceTrace() if trace else None
        self.t0 = self.t1 = None
        self.counters = {}
        self.class_lat = {}
        self.t_process = time.perf_counter()

    def stage(self, name: str) -> None:
        _stage(name, self.t_process)

    def _snapshot(self) -> dict:
        stats = [e.stats for e in _engines(self.program)]
        keys = {k for s in stats for k, v in s.items() if isinstance(v, (int, float))}
        out = {k: sum(s.get(k, 0) for s in stats) for k in keys}
        out["captured_on_run"] = sum(r.stats.get("captured_on_run", 0)
                                     for r in _routers(self.program))
        return out

    def _pop_class_lat(self) -> dict:
        out = {}
        for cls in ("short", "long"):
            lat = {}
            for e in _engines(self.program):
                for k, v in (e.stats.pop(cls + "_lat_ms", None) or {}).items():
                    lat.setdefault(k, []).extend(v)
            out[cls] = lat
        return out

    def open_window(self) -> None:
        self._pop_class_lat()
        self.counters["start"] = self._snapshot()
        self.t0 = time.perf_counter()
        self.stage("window.open")

    async def trace_after(self) -> None:
        """With a trace asked for, trace a stretch of the load that goes on
        right after the window (so that the window itself runs untraced)."""
        if self.device_trace is None:
            return
        await self.start_trace()
        await asyncio.sleep(self.trace_s)
        await self.stop_trace()

    async def start_trace(self) -> None:
        if self.device_trace is not None:
            await self._engine_parked(self.device_trace.start)

    async def stop_trace(self) -> None:
        if self.device_trace is not None and self.device_trace.t_start is not None:
            await self._engine_parked(self.device_trace.stop)

    async def _engine_parked(self, fn) -> None:
        """fn() on this thread while the engine's device thread waits,
        parked between two ticks, so that no other thread is inside a CUDA
        call. The profiler starting while that thread launched kernels
        hung the process for good (CUPTI enabling its activities). The
        engine's device thread is ``BatchedEngine._device_thread()``, the
        one-worker executor that runs every tick; where the engine has
        none, fn() runs at once."""
        get = getattr(_engines(self.program)[0], "_device_thread", None)
        if not callable(get):
            fn()
            return
        parked, release = threading.Event(), threading.Event()

        def hold():
            parked.set()
            release.wait()

        held = asyncio.get_running_loop().run_in_executor(get(), hold)
        try:
            while not parked.is_set():
                await asyncio.sleep(0.0005)
            fn()
        finally:
            release.set()
            await held

    def close_window(self) -> None:
        self.t1 = time.perf_counter()
        self.counters["end"] = self._snapshot()
        self.class_lat = self._pop_class_lat()
        self.stage("window.close")


class Reading:
    """What a metric reader reads."""

    def __init__(self, cell, window: Window, outcome: dict, setup_s: float, trace, device):
        self.cell = cell
        self.seed = window.seed
        self.device = device
        self.config = cell.config
        self.window_s = window.t1 - window.t0
        self.setup_s = setup_s
        self.samples = outcome["samples"]
        self.work = outcome["work"]
        self.counters = window.counters
        self.class_lat = window.class_lat
        self.trace = trace

    def probe_spec(self, name: str):
        """The shapes of kernel probe `name` in the cell's workload file."""
        return self.cell.workload.get("probes", {}).get(name)

    def counter_delta(self, key: str):
        a, b = self.counters.get("start", {}), self.counters.get("end", {})
        if key not in a or key not in b:
            return None
        return b[key] - a[key]


def sample_requests(candidates: list, k: int, seed: int) -> list:
    """k requests drawn from the seed, split evenly between the short
    class (budget <= 16 tokens) and the long one where both finished, and
    the one with the most served tokens."""
    if not candidates:
        return []
    rng = np.random.default_rng([seed, 9])
    classes = [[c for c in candidates if c["budget"] <= 16],
               [c for c in candidates if c["budget"] > 16]]
    classes = [c for c in classes if c]
    picked = [max(candidates, key=lambda c: len(c["tokens"]))]
    for group in classes:
        n = min(len(group), max(1, k // len(classes)))
        for i in rng.choice(len(group), size=n, replace=False):
            if all(group[i] is not p for p in picked):
                picked.append(group[i])
    return picked


def materialize(cfg: dict, reqs: list) -> tuple[list, int]:
    """The reference's view of each sampled request: the harness's own
    samples and the tokens served. -> (requests, file requests whose audio
    was not the harness's at any planned place)."""
    from gpubench.traffic.files import locate

    out, unmatched = [], 0
    buckets = cfg["serving"]["app"]["prefill_buckets"]
    fe = cfg["frontend"]
    for r in reqs:
        if r["path"] == "file":
            pcm = locate(r)
            if pcm is None:
                unmatched += 1
                continue
            out.append({"path": "file", "pcm": pcm, "tokens": list(r["tokens"])})
        else:
            bucket = frontend.chunk_bucket(r["chunk_count"], buckets, 1024, fe["hop_length"])
            out.append({"path": "ring", "pcm": r["pcm"], "bucket_samples": bucket * 1024,
                        "tokens": list(r["tokens"])})
    return out, unmatched


def judge(cell, family, seed: int, outcome: dict, device, control: bool = False):
    """-> (correct, {check: {"value", "limit"}}, the reference's readings)
    of a sample of what the window served, against model family `family`'s
    reference. `control`: also read the control on the same sample
    (calibration only)."""
    spec = cell.workload["check"]
    reqs = sample_requests(outcome["candidates"], spec["sample"], seed)
    mat, unmatched = materialize(cell.config, reqs)
    g = check.gaps(family, cell.config, seed, mat, device, control=control)
    checks = {
        "served_gap_per_tie": {"value": g["gap_per_tie"], "limit": spec["gap_per_tie_limit"],
                               "le": True},
        "tokens_compared": {"value": g["tokens"], "limit": spec["min_tokens"], "le": False},
        "audio_unmatched": {"value": unmatched, "limit": 0, "le": True},
        "failed": {"value": outcome["failed"], "limit": 0, "le": True},
    }
    ok = all((c["value"] <= c["limit"]) if c["le"] else (c["value"] >= c["limit"])
             for c in checks.values())
    print("reference: " + json.dumps({k: v for k, v in g.items() if k != "positions"}),
          file=sys.stderr, flush=True)
    return ok, {k: {"value": v["value"], "limit": v["limit"]} for k, v in checks.items()}, g


def trace_holds(tr: dict, trace_s: float) -> bool:
    """Whether a device trace stands for the stretch asked: it holds device
    events and spans at least half of `trace_s`. One that does not is
    dropped, so that its readers return nothing rather than an idle device."""
    return tr["kernels"] > 0 and tr["busy_s"] > 0 and tr["window_s"] >= 0.5 * trace_s


def _stage(name: str, t_process: float) -> None:
    """A line on standard error with the seconds since the process began,
    so that a slow or stuck run shows where its time went."""
    print(f"stage {name} +{time.perf_counter() - t_process:.1f} s", file=sys.stderr, flush=True)


def _finite(v: float) -> float:
    return 1e12 if math.isinf(v) else v


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_process: float,
             device_info=None, control: bool = False) -> dict:
    """One run. -> the result line's dict (with `control`, the reference's
    readings of the sample and of the control under "calibration")."""
    import torch

    family = cell.family()
    engine, vad, conf, info = system.build(cell.config, family, seed, device)
    print(f"built in {time.perf_counter() - t_process:.1f} s (warmup "
          f"{info['warmup_s']:.1f} s)", file=sys.stderr, flush=True)
    window = Window(cell, seed, seconds, trace, engine, vad, conf)
    window.t_process = t_process
    if trace:
        window.device_trace.warm(device)
    kind = cell.traffic()
    _stage("traffic", t_process)
    try:
        outcome = asyncio.run(kind.run(window))
    finally:
        engine.shutdown()
    _stage("traffic.done", t_process)
    setup_s = window.t0 - t_process
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    tr = window.device_trace.read(window.spans) if trace else None
    if trace:
        _stage("trace.read", t_process)
    if tr is not None:
        print(f"trace: {tr['kernels']} device events, busy {tr['busy_s']:.3f} of "
              f"{tr['window_s']:.3f} s", file=sys.stderr, flush=True)
        if not trace_holds(tr, window.trace_s):
            print(f"trace: dropped, it does not cover the load (asked {window.trace_s} s)",
                  file=sys.stderr, flush=True)
            tr = None
    reading = Reading(cell, window, outcome, setup_s, tr, device if cuda else None)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.metric_reader(m["name"], cell.root)(reading)
        if value is not None:
            metrics[m["name"]] = {"value": _finite(float(value)), "unit": m["unit"]}
    del engine, vad, window, reading
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    _stage("metrics", t_process)
    correct, checks, readings = judge(cell, family, seed, outcome, device, control)
    _stage("reference", t_process)
    result = {"correct": correct, "attempted": outcome["attempted"],
              "failed": outcome["failed"], "metrics": metrics}
    dev = dict(device_info or {"platform": "cpu", "kind": "cpu", "count": 0})
    if cuda:
        dev["memory_peak_bytes"] = int(peak)
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["device"] = dev
    if control:
        result["calibration"] = readings
    result["checks"] = checks
    return result
