"""Data-parallel serving: one continuous batcher per data row, behind a router;
each row tensor-parallel over its model ranks where the mesh has them.

JAX serves data-parallel inside ``BatchedEngine(mesh=...)``: one GSPMD
program over the mesh, parameters replicated, every slot and stream array
sharded over "data". The PyTorch idiom is a replica per data row
(``parallel/mesh.py``): its own card, ``Transcriber``, pools, ring, CUDA
graphs and device thread, and this router in front with the
``BatchedEngine`` interface that the sessions, the file pipeline, the
server and the load harness use.

- Sizes per replica: JAX rounds ``slots`` and ``n_streams`` up to the data
  degree and shards them, so each replica takes ``ceil(slots / dp)`` long
  slots and ``ceil(n_streams / dp)`` ring rows.
- Session affinity: ``alloc_stream`` claims a row on the replica with the
  most free rows and returns a global index, ``replica * rows + local``;
  every later call on that index (``ingest``, ``vad_window_ring``,
  ``transcribe_ring``, ``confirm_speculative``, ``interim_stagger``,
  ``free_stream``, the eager gate) goes to the replica that owns it.
- Host-audio requests (file segments, the host path of a session without a
  ring row) go to the replica with the fewest decodes in flight.
- The eager-finals gate is each replica's own (JAX's decisions on that
  replica's pools): ``eager_ok(stream_idx)`` asks the owner's; a host-path
  session (no row) asks the replica its next host request would go to, and
  its outcome reaches every replica's gate, as JAX's one gate sees every
  bet.
- ``alive`` is False while any replica's scheduler is crashed (``/health``
  says degraded); ``stats`` sums the replicas' counters under their keys and
  lists each replica's own under "replicas".

dp x tp: on a mesh with model_parallel > 1 (JAX's
``BatchedEngine(mesh=make_mesh(n, model_parallel=k))``) each data row is a
tensor-parallel group (parallel/tp.py) over ``mesh.devices[row]``: the
tree is cut into the row's Megatron shards (parallel/mesh.py:
shard_params_tp), each rank has its own Transcriber over its shard on its
card (models/config.py:tp_local), and the row's batcher is rank 0, which
runs every model program on all of its ranks in lockstep
(engine/batcher.py). The router, the affinity and the sizes are as above;
``stats`` lists each row's tp degree and its all-reduces.

There is no fallback: a replica that fails to build or start raises, and
nothing moves its streams to another card or to the CPU; a group that
fails to form, or a collective that times out, raises.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Optional

from sonicscribe_tpu_torch.engine.batcher import BatchedEngine
from sonicscribe_tpu_torch.engine.transcriber import Transcriber
from sonicscribe_tpu_torch.models.config import tp_local
from sonicscribe_tpu_torch.parallel.mesh import Mesh, replicate_params, shard_params_tp
from sonicscribe_tpu_torch.parallel.tp import TPGroup


def _replica_transcribers(transcriber: Transcriber, mesh: Mesh) -> list[Transcriber]:
    """A Transcriber per data row on its device; the given one serves the
    first row on its own device."""
    out, used = [], False
    for dev, params in zip(mesh.data_devices, replicate_params(transcriber.params, mesh)):
        if dev == transcriber.device and not used:
            out.append(transcriber)
            used = True
            continue
        out.append(_like(transcriber, transcriber.cfg, params))
    return out


def _like(transcriber: Transcriber, cfg, params) -> Transcriber:
    """A Transcriber with `transcriber`'s settings over another tree."""
    return Transcriber(cfg, params, transcriber.tokenizer, mel_cfg=transcriber.mel_cfg,
                       prefill_buckets=transcriber.buckets,
                       peak_normalize=transcriber.peak_normalize,
                       hotword_bias_strength=transcriber.hotword_bias_strength)


def _rank_transcribers(transcriber: Transcriber, mesh: Mesh,
                       row: int) -> tuple[TPGroup, list[Transcriber]]:
    """Data row `row`'s tensor-parallel group and a Transcriber per rank
    over its shard tree, on its card (rank 0 first)."""
    cfg = tp_local(transcriber.cfg, mesh.shape["model"])  # raises for what tp cannot serve
    group = TPGroup(mesh.devices[row])
    trees = group.attach(shard_params_tp(transcriber.params, mesh, transcriber.cfg, row),
                         transcriber.cfg)
    return group, [_like(transcriber, cfg, tree) for tree in trees]


class DataParallelEngine:
    """``BatchedEngine``'s interface over ``mesh.shape["data"]`` replicas."""

    has_ring = True

    def __init__(
        self,
        transcriber: Transcriber,
        vad,
        mesh: Mesh,
        slots: int = 8,
        max_decode_tokens: int = 256,
        n_streams: int = 64,
        base_logit_bias=None,
        fuse_dual_decode: bool = False,
    ):
        self.mesh = mesh
        self.data_parallel = dp = mesh.shape["data"]
        self.model_parallel = mesh.shape["model"]
        per_slots, self.rows_per_replica = -(-slots // dp), -(-n_streams // dp)
        if self.model_parallel > 1:
            rows = [_rank_transcribers(transcriber, mesh, row) for row in range(dp)]
        else:
            rows = [(None, [tr]) for tr in _replica_transcribers(transcriber, mesh)]
        self.replicas = [
            BatchedEngine(trs[0],
                          vad if vad.device == trs[0].device and i == 0 else vad.to(trs[0].device),
                          slots=per_slots, max_decode_tokens=max_decode_tokens,
                          n_streams=self.rows_per_replica, base_logit_bias=base_logit_bias,
                          fuse_dual_decode=fuse_dual_decode, tp_group=group,
                          tp_followers=trs[1:])
            for i, (group, trs) in enumerate(rows)]
        self.vad = self.replicas[0].vad
        self.N_STREAMS = dp * self.rows_per_replica
        self.concurrency_hint = sum(r.concurrency_hint for r in self.replicas)
        self._inflight = [0] * dp  # decodes the router has in flight on each replica
        self.allocated = [0] * dp  # ring rows alloc_stream gave out on each replica

    # ---------------- placement ----------------

    @property
    def transcriber(self) -> Transcriber:
        return self.replicas[0].transcriber

    @property
    def fuse_dual(self) -> bool:
        return self.replicas[0].fuse_dual

    def _owner(self, stream_idx: int) -> tuple[BatchedEngine, int]:
        r, local = divmod(stream_idx, self.rows_per_replica)
        return self.replicas[r], local

    def _pick(self) -> int:
        """The replica with the fewest decodes in flight (the first of
        those)."""
        return min(range(self.data_parallel), key=lambda r: (self._inflight[r], r))

    async def _counted(self, r: int, call):
        self._inflight[r] += 1
        try:
            return await call
        finally:
            self._inflight[r] -= 1

    # ---------------- lifecycle ----------------

    @property
    def alive(self) -> bool:
        return all(r.alive for r in self.replicas)

    async def start(self) -> None:
        for r in self.replicas:
            await r.start()

    def warmup(self, budgets=(15, 200, 256), full: bool = False, fast: bool = False) -> dict:
        """Each replica's warmup in turn (its graphs captured on its card).
        -> the sums, and each replica's own result."""
        t0 = time.perf_counter()
        each = [r.warmup(budgets=budgets, full=full, fast=fast) for r in self.replicas]
        return {"graphs": sum(w["graphs"] for w in each), "seconds": time.perf_counter() - t0,
                "deferred": sum(w["deferred"] for w in each), "replicas": each}

    def warmup_join(self, timeout: Optional[float] = None) -> None:
        for r in self.replicas:
            r.warmup_join(timeout)

    def drain_replays(self, timeout: Optional[float] = None) -> float:
        return sum(r.drain_replays(timeout) for r in self.replicas)

    def shutdown(self) -> None:
        for r in self.replicas:
            r.shutdown()

    async def between_ticks(self, fn):
        """fn() on the first replica's device thread between two of its
        ticks (BatchedEngine.between_ticks), every other replica's device
        thread parked meanwhile, so that no thread launches while fn runs.
        -> fn's result."""
        loop = asyncio.get_running_loop()
        release = threading.Event()
        parked = [loop.create_future() for _ in self.replicas[1:]]

        def hold(fut: asyncio.Future) -> None:
            loop.call_soon_threadsafe(lambda: fut.done() or fut.set_result(None))
            release.wait()

        holds = [loop.run_in_executor(r._device_thread(), hold, fut)
                 for r, fut in zip(self.replicas[1:], parked)]
        try:
            await asyncio.gather(*parked)
            return await self.replicas[0].between_ticks(fn)
        finally:
            release.set()
            await asyncio.gather(*holds)

    @property
    def stats(self) -> dict:
        """The replicas' integer counters and span and device seconds
        summed under their keys, and each replica's stats under
        "replicas", with its tp degree ("tp") and the all-reduces its rank 0
        ran ("all_reduces": eager on the CPU, graph replays on the card)."""
        out: dict = {}
        for r in self.replicas:
            for k, v in r.stats.items():
                if (isinstance(v, int) and not isinstance(v, bool)
                        or k.startswith(("span_s.", "device_s."))):
                    out[k] = out.get(k, 0) + v
        out["replicas"] = [dict(r.stats, tp=r.tp_degree,
                                all_reduces=r.router.stats["launches"].get("all_reduce", 0))
                           for r in self.replicas]
        return out

    # ---------------- host-audio requests ----------------

    async def transcribe(self, audio, sample_rate: int, max_new_tokens: int, **kw):
        r = self._pick()
        return await self._counted(r, self.replicas[r].transcribe(
            audio, sample_rate, max_new_tokens, **kw))

    async def vad_window_prob(self, audio, state):
        """The state is on the host, so any replica serves the window."""
        return await self.replicas[self._pick()].vad_window_prob(audio, state)

    # ---------------- ring streams (session affinity) ----------------

    def alloc_stream(self) -> Optional[int]:
        """A ring row on the replica with the most free rows; None when
        every replica is full."""
        r = max(range(self.data_parallel),
                key=lambda i: (len(self.replicas[i]._free_streams), -i))
        local = self.replicas[r].alloc_stream()
        if local is None:
            return None
        self.allocated[r] += 1
        return r * self.rows_per_replica + local

    def free_stream(self, idx: int) -> None:
        if idx is not None:
            eng, local = self._owner(idx)
            eng.free_stream(local)

    def interim_stagger(self, stream_idx: Optional[int]) -> float:
        if stream_idx is None:
            return self.replicas[0].interim_stagger(None)
        eng, local = self._owner(stream_idx)
        return eng.interim_stagger(local)

    def ingest(self, stream_idx: int, chunk_id: int, pcm: bytes) -> None:
        eng, local = self._owner(stream_idx)
        eng.ingest(local, chunk_id, pcm)

    async def vad_window_ring(self, stream_idx: int, start_chunk: int) -> float:
        eng, local = self._owner(stream_idx)
        return await eng.vad_window_ring(local, start_chunk)

    async def transcribe_ring(self, stream_idx: int, start_chunk: int, chunk_count: int,
                              max_new_tokens: int, **kw):
        r, local = divmod(stream_idx, self.rows_per_replica)
        return await self._counted(r, self.replicas[r].transcribe_ring(
            local, start_chunk, chunk_count, max_new_tokens, **kw))

    # ---------------- the eager-finals gate ----------------

    def eager_ok(self, stream_idx: Optional[int] = None) -> bool:
        if stream_idx is None:
            return self.replicas[self._pick()].eager_ok()
        eng, local = self._owner(stream_idx)
        return eng.eager_ok(local)

    def eager_outcome(self, confirmed: bool, stream_idx: Optional[int] = None) -> None:
        if stream_idx is None:
            for r in self.replicas:
                r.eager_outcome(confirmed)
            return
        eng, local = self._owner(stream_idx)
        eng.eager_outcome(confirmed, local)

    def confirm_speculative(self, stream_idx: int) -> None:
        eng, local = self._owner(stream_idx)
        eng.confirm_speculative(local)
