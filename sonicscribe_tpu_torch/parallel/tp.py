"""Tensor parallelism: the ranks of one model row, on threads, and their all-reduce.

The counterpart of what GSPMD does for the JAX package's dp x tp engine
(``sonicscribe_tpu/engine/batcher.py``, a mesh with "model" > 1): there
``shard_params_tp`` places the weight matrices over the mesh's "model"
axis and the compiler inserts a psum where a row-parallel product
contracts the sharded axis. In PyTorch that reduce is explicit:

- ``parallel/mesh.py:shard_params_tp`` cuts the tree into one Megatron
  shard per rank, head-aligned;
- ``TPGroup`` holds the ranks of one model row: one process group per
  rank over one in-process store (NCCL where the ranks are distinct
  cards, gloo on the CPU) and one thread per rank after the first, pinned
  to its card. ``run(fn)`` calls ``fn(rank)`` on every rank at once (rank
  0 on the calling thread) and returns rank 0's result: every program of
  a sharded model runs that way, so that the ranks' collectives meet, and
  a CUDA graph of it captures each rank's NCCL all-reduce;
- ``attach`` puts each rank's ``TPRank`` into its tree under "tp": the
  model's reduce hook (models/glm_asr.py), which all-reduces the partial
  sums of the blocks the degree splits (models/config.py:tp_blocks), and,
  under W8A8 decode, max-reduces each row's max|x| before a row-parallel
  product (``reduce_max``), whose kernel quantises the rank's share of the
  row with the whole row's scale.

Every rank must hold the same bits after a reduce: each rank picks its own
greedy tokens and writes its own KV from them, and they stay equal to rank
0's only because the reduced tensor is. NCCL's and gloo's all-reduce give
every rank the same result. The NCCL communicator is formed by one eager
all-reduce when the group is made, before any capture.

No fallback: a group that fails to form raises; a collective that does not
complete within ``timeout_s`` raises (gloo) and a rank whose part of
``run`` does not finish within it fails the call; after any failure the
group refuses further work, since its ranks' collectives can no longer
meet. NCCL refuses two ranks on one card, so a CUDA group needs distinct
cards. An NCCL group's communicators are never torn down: they live as
long as the process (see ``TPGroup.__init__``).
"""

from __future__ import annotations

import contextlib
import ctypes
import datetime
import itertools
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from sonicscribe_tpu_torch.ops import _build

TIMEOUT_S = 120.0  # a collective, or a rank's part of run() after rank 0's, past this fails
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
_group_ids = itertools.count()


class TPRank:
    """One rank's side of a group, carried in its shard tree under "tp":
    ``reduce(block, x)`` sums x over the ranks in place when the group's
    degree splits that block, ``reduce_max(block, x)`` takes its maximum;
    both return x as it is otherwise."""

    def __init__(self, group: "TPGroup", rank: int, blocks: frozenset):
        self.group, self.rank, self.blocks = group, rank, blocks

    def reduce(self, block: str, x: torch.Tensor) -> torch.Tensor:
        if block not in self.blocks:
            return x
        return self.group.all_reduce(self.rank, x)

    def reduce_max(self, block: str, x: torch.Tensor) -> torch.Tensor:
        if block not in self.blocks:
            return x
        return self.group.all_reduce(self.rank, x, op="max")


class TPGroup:
    """The ranks of one model row: ``devices[r]`` is rank r's card (all
    "cpu" for a gloo group). ``run`` drives them in lockstep."""

    def __init__(self, devices: Sequence, timeout_s: float = TIMEOUT_S):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        kinds = {d.type for d in self.devices}
        if self.size < 2:
            raise ValueError("a tensor-parallel group needs at least two ranks")
        if kinds == {"cuda"}:
            if len(set(self.devices)) < self.size:
                raise ValueError(f"NCCL refuses two ranks on one card: {self.devices}")
            self.backend = "nccl"
        elif kinds == {"cpu"}:
            self.backend = "gloo"
        else:
            raise ValueError(f"a group's ranks are all cards or all the CPU: {self.devices}")
        self.timeout_s = timeout_s
        self.failed: Optional[BaseException] = None
        self._closed = False
        self._executors = [
            ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"tp-rank{r}",
                               initializer=self._pin, initargs=(d,))
            for r, d in enumerate(self.devices[1:], start=1)]
        store = dist.PrefixStore(f"tp{next(_group_ids)}", dist.HashStore())
        self._pgs: list = [None] * self.size

        def form(r: int) -> None:
            self._pgs[r] = self._process_group(store, r)
            # one eager collective: NCCL forms its communicator here, before any capture
            x = torch.zeros(1, device=self.devices[r])
            self._pgs[r].allreduce([x]).wait()

        try:
            self.run(form)
        except BaseException:
            self.close()
            raise
        finally:
            if self.backend == "nccl":
                # An NCCL communicator of a process that holds its peers' too
                # waits, when it is torn down (aborted or destroyed, by
                # close() or by its destructor at exit, alone, one rank after
                # the other or in one NCCL group call), for its peers'
                # teardown until the timeout: on the H100 each abort timed
                # out. So the communicators live as long as the process,
                # which frees them when it ends, and their process groups
                # are kept from the destructor.
                for pg in self._pgs:
                    if pg is not None:
                        ctypes.pythonapi.Py_IncRef(ctypes.py_object(pg))

    def _process_group(self, store, rank: int):
        timeout = datetime.timedelta(seconds=self.timeout_s)
        if self.backend == "gloo":
            return dist.ProcessGroupGloo(store, rank, self.size, timeout)
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, self.size, opts)

    @staticmethod
    def _pin(device: torch.device) -> None:
        if device.type == "cuda":
            torch.cuda.set_device(device)

    def _on(self, rank: int):
        dev = self.devices[rank]
        return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()

    def _call(self, fn: Callable, rank: int, inference: bool):
        with torch.inference_mode(inference), self._on(rank):
            return fn(rank)

    def run(self, fn: Callable[[int], object]):
        """fn(rank) on every rank at once: rank 0 on the calling thread
        (with its card current), the others on their threads, each in the
        caller's inference mode. -> rank 0's result. Raises what any rank
        raised, or when a rank has not finished within timeout_s of rank
        0; the group then refuses further calls."""
        if self.failed is not None:
            raise RuntimeError("tensor-parallel group failed earlier; its ranks cannot meet "
                               "again") from self.failed
        if self._closed:
            raise RuntimeError("tensor-parallel group is closed")
        inference = torch.is_inference_mode_enabled()
        futures = [ex.submit(self._call, fn, r, inference)
                   for r, ex in enumerate(self._executors, start=1)]
        try:
            out = self._call(fn, 0, inference)
            for r, fut in enumerate(futures, start=1):
                try:
                    fut.result(timeout=self.timeout_s)
                except FutureTimeout:
                    raise RuntimeError(f"tensor-parallel rank {r} did not finish within "
                                       f"{self.timeout_s} s of rank 0") from None
        except BaseException as e:
            self.failed = e
            raise
        return out

    def all_reduce(self, rank: int, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce x over the ranks in place, its sum (op "sum") or its
        elementwise maximum ("max"), as rank `rank`'s call; every rank
        calls it with the same shape and op, in the same order. -> x, the
        same bits on every rank. Either op counts under "all_reduce" in
        the launch counters (a graph's replays count theirs through its
        router)."""
        if not x.is_contiguous():
            raise ValueError("all_reduce needs a contiguous tensor")
        if op not in _OPS:
            raise ValueError(f"all_reduce: op must be one of {sorted(_OPS)}, got {op!r}")
        opts = dist.AllreduceOptions()
        opts.reduceOp = _OPS[op]
        self._pgs[rank].allreduce([x], opts).wait()
        _build.count_launch("all_reduce")
        return x

    def attach(self, trees: list, cfg) -> list:
        """Each rank's tree (parallel/mesh.py:shard_params_tp) with its
        reduce hook under "tp"; cfg is the whole model's config."""
        from sonicscribe_tpu_torch.models.config import tp_blocks

        blocks = tp_blocks(cfg, self.size)
        return [dict(tree, tp=TPRank(self, r, blocks)) for r, tree in enumerate(trees)]

    def close(self) -> None:
        """Stop the ranks' threads; the group refuses further calls. An
        NCCL group's communicators stay until the process ends (see
        __init__)."""
        if self._closed:
            return
        self._closed = True
        for ex in self._executors:
            ex.shutdown(wait=False)
