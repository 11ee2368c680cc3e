"""Data-parallel serving over several cards: the mesh and its placements.

The port's counterpart of the JAX package's ``parallel/mesh.py``, under
its names. JAX serves data-parallel as one GSPMD program over a
("data", "model") mesh: parameters replicated, every per-slot and
per-stream array sharded over "data". PyTorch has no such compiler, so
the port's idiom is one replica per data row: its own copy of the
weights, its own pools, ring, CUDA graphs and device thread, behind a
router (``engine/replicas.py``). Sessions are independent, so nothing
crosses cards on the hot path, as in JAX.

- ``make_mesh`` lays the devices out as a [data, model] grid;
- ``replicate_params`` gives each data row its copy of a parameter tree;
- ``shard_batch`` cuts a tree of arrays into each data row's chunk.

Tensor parallelism (JAX's ``shard_params_tp``, ``batch_sharding``,
``replicated``: GSPMD placements over "model") is not here yet: a
Megatron split whose reduce crosses cards is a design of its own in
PyTorch. A mesh with model_parallel > 1 can be built and inspected, and
the data-parallel engine refuses it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """A [data, model] grid of torch devices. ``shape`` is JAX's
    ``{"data": .., "model": ..}``; ``data_devices`` the first device of
    each data row (where that row's replica lives)."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.devices = [list(row) for row in grid]

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def data_devices(self) -> list[torch.device]:
        return [row[0] for row in self.devices]


def _device(d) -> torch.device:
    """An explicit device; "cuda" without an index is the current card."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh with axes ("data", "model"); data = n_devices / model_parallel.

    Without `devices` it takes the CUDA devices, and raises without one. An
    explicit list may name a device more than once: two replicas on one
    card (the CPU tests pass "cpu" n times)."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("no CUDA device for the mesh; pass devices= (e.g. ['cpu'] * n) "
                               "to lay it out on the CPU")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [_device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return Mesh([devs[i:i + model_parallel] for i in range(0, n, model_parallel)])


def _tree_map(fn, tree):
    """fn over the tensor leaves of nested dicts / lists / tuples; other
    leaves (a QTensor's "layer" int) as they are."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def replicate_params(params, mesh: Mesh) -> list:
    """One copy of the parameter tree per data row, each on that row's
    device: plain, int8 and int4 trees alike (ops/quant.py's QTensor dicts
    are walked like any other level). A leaf already on the row's device is
    shared, not copied: weights are read-only, so replicas on one card
    hold one copy."""
    return [_tree_map(lambda t, d=dev: t.to(d), params) for dev in mesh.data_devices]


def shard_batch(tree, mesh: Mesh, axis: int = 0) -> list:
    """Each data row's chunk of every array leaf along `axis`, on that
    row's device. A leaf whose axis does not divide by the data degree
    (or that has no such axis) goes whole to every row, as JAX's falls
    back to replication."""
    dp = mesh.shape["data"]

    def chunk(r: int, dev: torch.device):
        def cut(t: torch.Tensor) -> torch.Tensor:
            if t.dim() > axis and t.shape[axis] % dp == 0:
                n = t.shape[axis] // dp
                t = t.narrow(axis, r * n, n)
            return t.to(dev)
        return cut

    return [_tree_map(chunk(r, dev), tree) for r, dev in enumerate(mesh.data_devices)]
