"""The benchmark's spans and its reading of the device trace.

Spans: the harness wraps its calls into each layer (``span(name)``) and
keeps name, start, end and parent in memory; nothing is written out.

The device trace: ``torch.profiler`` over the window's last stretch. From
its device events (kernels, copies, sets) come the busy seconds (their
union), the idle gaps between them, and the time by op group (the kernel
name patterns of the port's ``tools/bench_decode_parts.py``, copied).
Each idle gap is named by the harness's spans open at the time.
"""

from __future__ import annotations

import contextlib
import sys
import time

OP_GROUPS = (
    ("decode_attention", ("decode_attention_split_kernel", "decode_attention_merge_kernel",
                          "verify_attention")),
    ("int8/int4 matmul", ("w8a16", "w8a8", "w4a16", "w4a8", "Int8Rows", "W8A8Rows",
                          "Int4Rows")),
    ("log_mel", ("log_mel",)),
    ("gemm", ("nvjet", "gemm", "gemv", "cutlass", "sm90_xmma", "splitKreduce", "cublas")),
    ("argmax", ("ArgMaxOps",)),
    ("reduction (RMSNorm mean)", ("MeanOps", "reduce_kernel")),
    ("rsqrt", ("rsqrt",)),
    ("decode glue (add+RMSNorm, QKV+RoPE+K/V write, SiLU·up)",
     ("add_rms_norm_kernel", "qkv_rope_kv_write_kernel", "silu_mul_kernel")),
    ("silu", ("silu",)),
    ("where", ("where_kernel",)),
    ("index_put/scatter (K/V write)", ("index_put", "scatter")),
    ("index (K/V rows read for the write)", ("index_kernel",)),
    ("embedding gather", ("gather_kernel", "indexSelect")),
    ("cat", ("CatArrayBatchedCopy",)),
    ("copy/cast", ("copy_kernel", "direct_copy", "Memcpy", "memcpy", "bfloat16_copy",
                   "float16_copy")),
    ("rope tables (arange, pow, div, reciprocal, cos, sin)",
     ("arange", "pow", "DivFunctor", "div_true", "reciprocal", "cos_kernel", "sin_kernel")),
    ("add/sub", ("CUDAFunctor_add", "CUDAFunctorOnSelf_add", "AddFunctor", "add_kernel")),
    ("mul", ("MulFunctor", "mul_kernel")),
    ("compare/clamp/not/fill", ("Compare", "compare", "clamp", "bitwise_not", "FillFunctor",
                                "fill_kernel", "Memset", "memset")),
)


def op_group(name: str) -> str:
    for group, patterns in OP_GROUPS:
        if any(p in name for p in patterns):
            return group
    return "other"


class Spans:
    def __init__(self):
        self.records = []  # (name, start, end, parent)
        self._open = []

    @contextlib.contextmanager
    def span(self, name: str):
        parent = self._open[-1] if self._open else None
        t0 = time.perf_counter()
        self._open.append(name)
        try:
            yield
        finally:
            self._open.remove(name)
            self.records.append((name, t0, time.perf_counter(), parent))

    def open_at(self, t: float) -> str:
        names = sorted({n for n, a, b, _ in self.records if a <= t <= b})
        return "+".join(names) or "none"


class DeviceTrace:
    """torch.profiler from start() to stop(); then busy_s, window_s, the
    op groups and the idle gaps of the device."""

    def __init__(self):
        self._prof = None
        self.t_start = self.t_stop = None

    @staticmethod
    def _profile():
        import torch

        return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])

    def warm(self, device) -> None:
        """Profile one tiny op in set-up, so that the profiler's first start
        (seconds, with the event loop held) is not paid after the window."""
        import torch

        with self._profile():
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize(device)

    def start(self) -> None:
        import torch

        print(f"stage trace.start at {time.perf_counter():.3f}", file=sys.stderr, flush=True)
        self._prof = self._profile()
        self._prof.start()
        with torch.profiler.record_function("gpubench.mark"):
            self._mark = time.perf_counter()
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self._prof.stop()
        print(f"stage trace.stop at {self.t_stop:.3f}, {self.t_stop - self.t_start:.3f} s traced, "
              f"stopped in {time.perf_counter() - self.t_stop:.3f} s", file=sys.stderr, flush=True)

    def read(self, spans: Spans) -> dict:
        """-> {"busy_s", "window_s", "device_ops", "idle_gaps", "kernels"}."""
        events = self._prof.profiler.kineto_results.events()
        dev, mark = [], None
        for e in events:
            name = e.name()
            if name == "gpubench.mark":
                mark = e.start_ns() / 1e9
            elif e.device_type().name == "CUDA":
                dev.append((e.start_ns() / 1e9, e.duration_ns() / 1e9, name))
        dev.sort()
        # host time of a trace time: the mark's host clock less its trace time
        offset = (self._mark - mark) if mark is not None else None
        busy, groups, gaps = 0.0, {}, []
        end = None
        for t, d, name in dev:
            g = op_group(name)
            groups[g] = groups.get(g, 0.0) + d
            if end is None or t > end:
                if end is not None:
                    gaps.append((t - end, end))
                busy += d
                end = t + d
            elif t + d > end:
                busy += t + d - end
                end = t + d
        gaps.sort(reverse=True)
        named = []
        for length, at in gaps[:10]:
            label = spans.open_at(at + length / 2 + offset) if offset is not None else "none"
            named.append([f"idle while {label}", length])
        return {
            "busy_s": busy,
            "window_s": self.t_stop - self.t_start,
            "device_ops": sorted(([k, v] for k, v in groups.items()), key=lambda kv: -kv[1])[:10],
            "idle_gaps": named,
            "kernels": len(dev),
        }
