"""Percentiles and rates are taken over every sample of the window."""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import pytest

from gpubench import manifest, stats


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1001])
def test_percentile_is_numpys_over_all_samples(n):
    xs = list(np.random.default_rng(n).exponential(100.0, size=n))
    for p in (50, 95, 99):
        assert stats.percentile(xs, p) == pytest.approx(float(np.percentile(xs, p)))


def test_a_failure_ranks_above_every_sample():
    xs = [10.0] * 99 + [math.inf]
    assert stats.percentile(xs, 50) == 10.0
    assert math.isinf(stats.percentile(xs, 100))
    assert math.isinf(stats.percentile([1.0] * 19 + [math.inf] * 2, 95))
    assert stats.percentile([], 95) is None


def _reading(**kw):
    base = dict(samples={}, window_s=40.0, setup_s=80.0, class_lat={}, counters={},
                work=[], trace=None, device=None)
    base.update(kw)
    r = SimpleNamespace(**base)
    r.counter_delta = lambda k: r.counters["end"][k] - r.counters["start"][k]
    return r


def test_readers_take_every_sample_of_the_window():
    lat = list(np.random.default_rng(0).normal(150.0, 20.0, size=537))
    r = _reading(samples={"interim_ms": lat, "commit_ms": lat[:300], "file_audio_s": 4000.0},
                 class_lat={"short": {"queue": lat}, "long": {"queue": lat[:10]}},
                 counters={"start": {"captured_on_run": 3}, "end": {"captured_on_run": 3}},
                 trace={"busy_s": 0.75, "window_s": 1.0})
    read = manifest.metric_reader
    assert read("stream_interim_p95_ms")(r) == pytest.approx(np.percentile(lat, 95))
    assert read("stream_commit_p95_ms")(r) == pytest.approx(np.percentile(lat[:300], 95))
    assert read("file_audio_s_per_s")(r) == pytest.approx(100.0)
    assert read("batcher.short_queue_p95_ms")(r) == pytest.approx(np.percentile(lat, 95))
    assert read("batcher.long_queue_p95_ms")(r) == pytest.approx(np.percentile(lat[:10], 95))
    assert read("graphs.captured_on_run.stream")(r) == 0
    assert read("device.idle_share.file")(r) == pytest.approx(25.0)
    assert read("setup_s")(r) == 80.0


def test_a_reader_with_nothing_to_read_returns_nothing():
    r = _reading()
    for name in ("file_audio_s_per_s", "stream_interim_p95_ms",
                 "device.idle_share.stream", "model.mfu.file",
                 "kern.decode_attention.roofline.file"):
        r.probe_spec = lambda name: None
        assert manifest.metric_reader(name)(r) is None, name


@pytest.mark.parametrize("kernels,busy_s,window_s,holds", [
    (4210, 0.81, 1.02, True),
    (0, 0.0, 0.0025, False),  # the profiler caught nothing
    (0, 0.0, 1.01, False),  # a full stretch with no device event
    (37, 0.004, 0.032, False),  # the stretch cut short
])
def test_a_trace_that_misses_the_load_is_dropped(kernels, busy_s, window_s, holds):
    from gpubench.harness import trace_holds

    tr = {"kernels": kernels, "busy_s": busy_s, "window_s": window_s}
    assert trace_holds(tr, 1.0) is holds


def test_the_trace_starts_and_stops_with_the_engine_thread_parked():
    """No tick runs on the engine's device thread while the profiler starts
    or stops: a tick submitted meanwhile waits until it is done."""
    import asyncio
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor

    from gpubench.harness import Window

    executor = ThreadPoolExecutor(max_workers=1)
    window = Window.__new__(Window)
    window.program = SimpleNamespace(_device_thread=lambda: executor)
    log, ticked, pending = [], threading.Event(), []

    def tick():
        ticked.set()
        log.append("tick")

    def profiler_call():
        pending.append(executor.submit(tick))
        time.sleep(0.05)
        log.append("profiler during a tick" if ticked.is_set() else "profiler")

    asyncio.run(window._engine_parked(profiler_call))
    pending[0].result(timeout=5)
    executor.shutdown()
    assert log == ["profiler", "tick"]


GLUE = "decode glue (add+RMSNorm, QKV+RoPE+K/V write, SiLU·up)"


@pytest.mark.parametrize("kernel,group", [
    ("void add_rms_norm_kernel<__nv_bfloat16>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16*, __nv_bfloat16*, int, float, float)", GLUE),
    ("void qkv_rope_kv_write_kernel<float>(float const*, float const*, float*)", GLUE),
    ("void silu_mul_kernel<__nv_bfloat16>(__nv_bfloat16 const*, __nv_bfloat16*, long long, int)",
     GLUE),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::silu_kernel", "silu"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>",
     "add/sub"),
])
def test_the_breakdown_names_the_decode_glue_kernels(kernel, group):
    from gpubench.trace import op_group

    assert op_group(kernel) == group
