"""Captured programs: CUDA graphs keyed as the JAX package keys its executables.

Counterpart of the JAX package's ``engine/exec_store.py`` (``ExecRouter``).
There, each program of the transcriber is one compiled XLA executable per
key; here each is one CUDA graph per key, captured on its first dispatch
(or by ``Transcriber.warmup``) and replayed after that, so a request costs
a few graph launches instead of one host dispatch per PyTorch op.

A program is a function of one dict of static buffers. The caller owns the
buffers of a key, allocates them once and copies a request's inputs into
them before each dispatch; the graph reads and writes the same addresses
on every replay, and a program's outputs are tensors the graph writes.

Capture, per key:

1. one eager run of the program on copies of its buffers, on the capture
   stream: it builds the CUDA kernels (``ops/_build.load``) and warms
   cuBLAS, cuDNN and the allocator, and leaves the buffers as they were;
2. ``torch.cuda.graph`` on that stream, into one memory pool shared by
   every graph of the router (one device thread replays them in turn, so
   no two of them are live at once), in ``thread_local`` error mode, so
   that another thread's work on the card (``/transcribe/file`` resamples
   uploads on it) neither fails nor invalidates the capture.

A graph's cuBLAS products write into the workspace PyTorch keeps for the
capture stream; ``torch._C._cuda_clearCublasWorkspaces()`` frees it, and a
replay after that writes into freed memory. Nothing in the package calls it.

``run`` then replays the graph; ``prepare`` (the transcriber's warmup)
replays it once more, uncounted, so that the graph is uploaded to the
device before the first request. A capture or replay that fails raises: on
the card no program runs eagerly. On the CPU (``device="cpu"``, as the
tests ask) ``run`` calls the program itself: the path the caller asked for.

Launch counts. A kernel wrapper adds to ``ops/_build.launch_counts`` in
Python, which runs while the graph is recorded and never at a replay. The
router takes back what the capture procedure added (its eager run and
the recording) and adds what the recording added at every replay, so the
counts say what the replays launched.

No disk store. ``ExecStore`` pickles XLA executables so that a restarted
server skips tracing and compiling. A CUDA graph holds device addresses of
one process and cannot be serialized; a restart here costs the nvcc build,
which ``ops/_build.py`` caches on disk by digest, and one capture per key.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch

from sonicscribe_tpu_torch.ops import _build

Program = Callable[[dict], dict]


@dataclass
class Captured:
    graph: object  # torch.cuda.CUDAGraph
    outputs: dict  # tensors the graph writes
    launches: dict  # kernel launches per replay, by launch counter
    capture_s: float


class GraphRouter:
    """Dispatch programs as CUDA graphs, one per key (eagerly on the CPU).

    `stats`: graphs captured, replays counted (`run`'s), and the seconds
    each key's capture took (`capture_s`, by key).
    """

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.entries: dict = {}
        self.stats = {"graphs": 0, "replays": 0, "capture_s": {}}
        self._pool = None
        self._stream = None

    def run(self, key, program: Program, bufs: dict) -> dict:
        """The program's outputs on `bufs`: the key's graph replayed
        (captured first if missing), or on the CPU the program itself."""
        if self.device.type == "cpu":
            return program(bufs)
        entry = self.entries.get(key) or self._capture(key, program, bufs)
        entry.graph.replay()
        for name, n in entry.launches.items():
            _build.launch_counts[name] += n
        self.stats["replays"] += 1
        return entry.outputs

    def prepare(self, key, program: Program, bufs: dict) -> Captured | None:
        """Capture the key's graph if it has none, and replay it once,
        uncounted: the first replay uploads the graph to the device and
        shows that it runs, ahead of the first request. The buffers must
        hold a state the program can run on, and their next user sets them
        anew. None on the CPU."""
        if self.device.type == "cpu":
            return None
        entry = self.entries.get(key)
        if entry is None:
            entry = self._capture(key, program, bufs)
            entry.graph.replay()
        return entry

    def _capture(self, key, program: Program, bufs: dict) -> Captured:
        t0 = time.perf_counter()
        before = dict(_build.launch_counts)
        self._warm(program, bufs)
        warm = dict(_build.launch_counts)
        graph, outputs = self._record(program, bufs)
        launches = {k: v - warm[k] for k, v in _build.launch_counts.items() if v != warm[k]}
        _build.launch_counts.update(before)
        entry = self.entries[key] = Captured(graph, outputs, launches, time.perf_counter() - t0)
        self.stats["graphs"] += 1
        self.stats["capture_s"][key] = entry.capture_s
        return entry

    def _capture_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def _warm(self, program: Program, bufs: dict) -> None:
        """One eager run on copies of the buffers (a dict of them copied
        field by field), on the capture stream."""
        stream = self._capture_stream()
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            program({k: {f: t.clone() for f, t in v.items()} if isinstance(v, dict)
                     else v.clone() for k, v in bufs.items()})
        torch.cuda.current_stream(self.device).wait_stream(stream)

    def _record(self, program: Program, bufs: dict):
        stream = self._capture_stream()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=stream,
                              capture_error_mode="thread_local"):
            outputs = program(bufs)
        return graph, outputs
