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
   cuBLAS, cuDNN and the allocator, and leaves the buffers as they were.
   The buffers the router was told to warm in place (``warm_in_place``:
   the batcher's KV caches and audio ring, where its programs write only
   what no live slot reads before writing it again) are not copied, which
   keeps their size out of the capture's memory peak;
2. ``CUDAGraph.capture_begin`` / ``capture_end`` on that stream, into one
   memory pool shared by every graph of the router (one device thread
   replays them in turn, so no two of them are live at once), in
   ``thread_local`` error mode, so that another thread's work on the card
   (``/transcribe/file`` resamples uploads on it) neither fails nor
   invalidates the capture. Not the ``torch.cuda.graph`` context: it
   synchronizes the device and empties the device and pinned-host caches
   first, which a capture between serving ticks pays for (it frees every
   pinned block the ticks' host copies left behind).

A graph's cuBLAS products write into the workspace PyTorch keeps for the
capture stream; ``torch._C._cuda_clearCublasWorkspaces()`` frees it, and a
replay after that writes into freed memory. Nothing in the package calls it.

``run`` then replays the graph; ``prepare`` (the transcriber's warmup)
replays it once more, uncounted, so that the graph is uploaded to the
device before the first request, unless asked not to (a key captured
beside live state, whose replay would step it). A capture or replay that fails raises: on
the card no program runs eagerly. On the CPU (``device="cpu"``, as the
tests ask) ``run`` calls the program itself: the path the caller asked for.

Launch counts. A kernel wrapper adds to ``ops/_build.launch_counts`` in
Python, which runs while the graph is recorded and never at a replay. The
router takes back what the capture procedure added (its eager run and
the recording) and adds what the recording added at every replay, so the
counts say what the replays launched. It counts what its own thread added
(``_build.recording``), so the ranks of a tensor-parallel group capture
at once on their threads, each router keeping its own rank's launches.

Tensor parallelism. Each rank of a group (``parallel/tp.py``) has its own
router on its card. A program of a sharded model all-reduces inside it,
so its warm run, its capture and every replay run on all ranks in
lockstep, one thread per rank: the engine that dispatches it calls the
group (``engine/batcher.py``), and the NCCL all-reduce is captured into
each rank's graph like any kernel.

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
    warm_s: float  # the part of capture_s its eager warm run took


class GraphRouter:
    """Dispatch programs as CUDA graphs, one per key (eagerly on the CPU).

    `stats`: graphs captured, those `run` captured on a first dispatch
    (`captured_on_run`, a request's path), replays counted (`run`'s), and
    the seconds each key's capture took (`capture_s`, by key; `warm_s`:
    the part its eager warm run took), and the kernel launches its replays
    made (`launches`, by launch counter: this router's share of
    `_build.launch_counts`, which tells replicas apart on one card; on the
    CPU what its programs counted, the all-reduces of a tensor-parallel
    rank).
    `warm_in_place`: names of buffers the warm run uses as they are.
    """

    def __init__(self, device: torch.device, warm_in_place: tuple = ()):
        self.device = torch.device(device)
        self.warm_in_place = frozenset(warm_in_place)
        self.entries: dict = {}
        self.stats = {"graphs": 0, "captured_on_run": 0, "replays": 0, "capture_s": {},
                      "warm_s": {}, "launches": {}}
        self._pool = None
        self._stream = None

    def run(self, key, program: Program, bufs: dict) -> dict:
        """The program's outputs on `bufs`: the key's graph replayed
        (captured first if missing), or on the CPU the program itself."""
        if self.device.type == "cpu":
            with _build.recording() as counted:
                out = program(bufs)
            self._note_launches(counted)
            return out
        entry = self.entries.get(key)
        if entry is None:
            entry = self._capture(key, program, bufs)
            self.stats["captured_on_run"] += 1
        entry.graph.replay()
        for name, n in entry.launches.items():
            _build.count_launch(name, n)
        self._note_launches(entry.launches)
        self.stats["replays"] += 1
        return entry.outputs

    def _note_launches(self, counts: dict) -> None:
        mine = self.stats["launches"]
        for name, n in counts.items():
            mine[name] = mine.get(name, 0) + n

    def prepare(self, key, program: Program, bufs: dict, replay: bool = True) -> Captured | None:
        """Capture the key's graph if it has none, and (`replay`) replay it
        once, uncounted: the first replay uploads the graph to the device
        and shows that it runs, ahead of the first request. The buffers
        must hold a state the program can run on, and their next user sets
        them anew. None on the CPU."""
        if self.device.type == "cpu":
            return None
        entry = self.entries.get(key)
        if entry is None:
            entry = self._capture(key, program, bufs)
            if replay:
                entry.graph.replay()
        return entry

    def _capture(self, key, program: Program, bufs: dict) -> Captured:
        t0 = time.perf_counter()
        with _build.recording() as warm:
            self._warm(program, bufs)
        warm_s = time.perf_counter() - t0
        with _build.recording() as recorded:
            graph, outputs = self._record(program, bufs)
        _build.take_back(warm)
        _build.take_back(recorded)
        launches = {k: v for k, v in recorded.items() if v}
        entry = self.entries[key] = Captured(graph, outputs, launches, time.perf_counter() - t0,
                                             warm_s)
        self.stats["graphs"] += 1
        self.stats["capture_s"][key] = entry.capture_s
        self.stats["warm_s"][key] = warm_s
        return entry

    def _capture_stream(self) -> torch.cuda.Stream:
        """The router's capture stream on its card (made on first use). The
        warm run and the recording run under it, which makes its card
        current for them whatever the calling thread's card is."""
        if self._stream is None:
            with torch.cuda.device(self.device):
                self._stream = torch.cuda.Stream(self.device)
                self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def _warm(self, program: Program, bufs: dict) -> None:
        """One eager run on copies of the buffers (a dict of them copied
        field by field; those named in warm_in_place used as they are), on
        the capture stream."""
        def copy(name, t):
            return t if name in self.warm_in_place else t.clone()

        stream = self._capture_stream()
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            program({k: {f: copy(f, t) for f, t in v.items()} if isinstance(v, dict)
                     else copy(k, v) for k, v in bufs.items()})
        torch.cuda.current_stream(self.device).wait_stream(stream)

    def _record(self, program: Program, bufs: dict):
        stream = self._capture_stream()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            graph.capture_begin(self._pool, capture_error_mode="thread_local")
            try:
                outputs = program(bufs)
            finally:
                graph.capture_end()
        return graph, outputs
