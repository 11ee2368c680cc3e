"""Data- and tensor-parallel serving over several cards: the mesh and its placements.

The port's counterpart of the JAX package's ``parallel/mesh.py``, under
its names. JAX serves data-parallel as one GSPMD program over a
("data", "model") mesh: parameters replicated, every per-slot and
per-stream array sharded over "data". PyTorch has no such compiler, so
the port's idiom is one replica per data row: its own copy of the
weights, its own pools, ring, CUDA graphs and device thread, behind a
router (``engine/replicas.py``). Sessions are independent, so nothing
crosses cards on the hot path, as in JAX.

- ``make_mesh`` lays the devices out as a [data, model] grid;
- ``replicate_params`` gives each data row its copy of a parameter tree,
  every leaf placed ``replicated`` (whole on each row);
- ``shard_batch`` cuts a tree of arrays into each data row's chunk, a
  leaf placed by ``batch_sharding`` (cut along an axis over the rows);
- ``shard_params_tp`` cuts a tree into the Megatron shards of one data
  row's model ranks (tensor parallelism: ``parallel/tp.py`` runs them).

Tensor-parallel shards. JAX's ``_TP_RULES`` and ``shard_params_tp`` name
the leaves a "model" axis cuts, column-parallel (the projection into a
block, cut on its output axis) or row-parallel (the projection out of it,
cut on its input axis), and GSPMD reshards wherever a cut does not line up
with the layer body. Here each rank runs the layer body on its own shard,
so the cuts differ from JAX's in two ways, on purpose:

- head-aligned fused layouts: ``qkv_w`` / ``qkv_b`` are cut per section
  (rank r holds [its q heads | its k heads | its v heads]) and
  ``gate_up_w`` per half ([its gate shard | its up shard]), where JAX cuts
  the fused axis contiguously;
- the divisibility rule holds per block (``models/config.py:tp_blocks``):
  where a block's heads or hidden width do not divide by the degree, its
  column / row pair and their biases stay replicated whole (a Megatron
  pair cannot be half replicated), where JAX replicates leaf by leaf.

Replicated as in JAX: ``embed`` (and ``lm_head``), the norms, the convs,
and the biases added after a row-parallel product (``o_b``, ``fc2_b``,
the adapter's ``fc2.b``). An int8 tree is quantised first and cut after:
``q`` as its weight; ``scale`` (one per output column, an amax over the
whole K) cut like the weight under a column rule and replicated under a
row rule. Every shard is a contiguous copy of its own (the int8 kernels
refuse views and need 16-byte alignment).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from sonicscribe_tpu_torch.models.config import GlmAsrConfig, tp_blocks


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


@dataclass(frozen=True)
class Placement:
    """Where a leaf goes on a mesh (JAX's NamedSharding): to every data
    row whole (axis None: ``replicated``) or cut along `axis` into one
    chunk per data row (``batch_sharding``), on the row's device."""

    mesh: Mesh
    axis: Optional[int] = None

    def place(self, t: torch.Tensor, row: int) -> torch.Tensor:
        """Data row `row`'s part of t, on its device. A leaf already there
        whole is shared, not copied: weights are read-only, so replicas on
        one card hold one copy."""
        if self.axis is not None:
            n = t.shape[self.axis] // self.mesh.shape["data"]
            t = t.narrow(self.axis, row * n, n)
        return t.to(self.mesh.data_devices[row])


def batch_sharding(mesh: Mesh, ndim: int, axis: int = 0) -> Placement:
    """An ndim-dimensional leaf cut along `axis` over the data rows."""
    if not 0 <= axis < ndim:
        raise ValueError(f"axis {axis} out of range for {ndim} dimensions")
    return Placement(mesh, axis)


def replicated(mesh: Mesh) -> Placement:
    """A leaf whole on every data row."""
    return Placement(mesh)


def replicate_params(params, mesh: Mesh) -> list:
    """One copy of the parameter tree per data row, each on that row's
    device (``replicated``): plain, int8 and int4 trees alike
    (ops/quant.py's QTensor dicts are walked like any other level)."""
    whole = replicated(mesh)
    return [_tree_map(lambda t, r=r: whole.place(t, r), params)
            for r in range(mesh.shape["data"])]


def shard_batch(tree, mesh: Mesh, axis: int = 0) -> list:
    """Each data row's chunk of every array leaf along `axis`, on that
    row's device (``batch_sharding``). A leaf whose axis does not divide by
    the data degree (or that has no such axis) goes whole to every row
    (``replicated``), as JAX's falls back to replication."""
    dp = mesh.shape["data"]

    def placement(t: torch.Tensor) -> Placement:
        if t.dim() > axis and t.shape[axis] % dp == 0:
            return batch_sharding(mesh, t.dim(), axis)
        return replicated(mesh)

    return [_tree_map(lambda t, r=r: placement(t).place(t, r), tree) for r in range(dp)]


# Tensor-parallel rules for the GLM-ASR tree, by subtree and leaf name (an
# int8 QTensor's "q" and "scale" take their weight's rule): the leaves of
# the JAX package's _TP_RULES with the same roles, and the block each
# belongs to (its all-reduce site in models/glm_asr.py). Column: the
# output axis (the last) is cut; row: the input axis (the one before it).
COLUMN, ROW = "column", "row"
_TP_RULES = {
    "encoder": {
        # attention and MLP (d_model -> d_model, head-aligned)
        "q_w": (COLUMN, "encoder_attn"), "q_b": (COLUMN, "encoder_attn"),
        "k_w": (COLUMN, "encoder_attn"),
        "v_w": (COLUMN, "encoder_attn"), "v_b": (COLUMN, "encoder_attn"),
        "o_w": (ROW, "encoder_attn"),
        "fc1_w": (COLUMN, "encoder_mlp"), "fc1_b": (COLUMN, "encoder_mlp"),
        "fc2_w": (ROW, "encoder_mlp"),
    },
    "adapter": {  # the MLP's hidden axis
        "fc1.w": (COLUMN, "adapter"), "fc1.b": (COLUMN, "adapter"),
        "fc2.w": (ROW, "adapter"),
    },
    "decoder": {  # GQA and SwiGLU; qkv and gate_up cut per section
        "qkv_w": (COLUMN, "decoder_attn"), "qkv_b": (COLUMN, "decoder_attn"),
        "o_w": (ROW, "decoder_attn"),
        "gate_up_w": (COLUMN, "decoder_mlp"),
        "down_w": (ROW, "decoder_mlp"),
    },
}


def tp_rule(path: Sequence[str]) -> Optional[tuple[str, str]]:
    """(role, block) of the leaf at `path` (its keys from the root; a
    QTensor's "q" / "scale" last), or None for a replicated leaf."""
    keys = list(path[:-1]) if path[-1] in ("q", "scale") else list(path)
    rules = _TP_RULES.get(keys[0], {})
    return rules.get(f"{keys[-2]}.{keys[-1]}") or rules.get(keys[-1])


def _sections(cfg: GlmAsrConfig, name: str, width: int) -> list[int]:
    """The fused output axis of a column leaf as its sections, each cut on
    its own: [q, k, v] for qkv, [gate, up] for gate_up, else the whole."""
    dec = cfg.decoder
    if name in ("qkv_w", "qkv_b"):
        kv = dec.n_kv_heads * dec.head_dim
        return [dec.n_heads * dec.head_dim, kv, kv]
    if name == "gate_up_w":
        return [width // 2, width // 2]
    return [width]


def _cut(t: torch.Tensor, axis: int, sections: list[int], rank: int, tp: int) -> torch.Tensor:
    """Rank `rank`'s share of every section of t's `axis`, concatenated: a
    new contiguous tensor."""
    parts, start = [], 0
    for n in sections:
        parts.append(t.narrow(axis, start + rank * (n // tp), n // tp))
        start += n
    return torch.cat(parts, dim=axis)


def shard_params_tp(params, mesh: Mesh, cfg: GlmAsrConfig, row: int = 0) -> list:
    """The Megatron shards of `params` (the whole model's tree, plain or
    int8; `cfg` its config) for data row `row`'s model ranks: one tree per
    rank, on ``mesh.devices[row][rank]``, rank-local shapes as
    ``models/config.py:tp_local`` gives them. Leaves of a block the degree
    does not split, and leaves without a rule, go whole to every rank."""
    devices = mesh.devices[row]
    tp = len(devices)
    split = tp_blocks(cfg, tp)

    def shard(path: tuple, t: torch.Tensor, rank: int) -> torch.Tensor:
        rule = tp_rule(path)
        if rule is None or rule[1] not in split:
            return t.to(devices[rank])
        role, _ = rule
        name = path[-2] if path[-1] in ("q", "scale") else path[-1]
        if role == ROW:
            if path[-1] == "scale":  # per output column: whole under a row cut
                return t.to(devices[rank])
            return _cut(t, t.dim() - 2, [t.shape[-2]], rank, tp).to(devices[rank])
        return _cut(t, t.dim() - 1, _sections(cfg, name, t.shape[-1]), rank, tp).to(
            devices[rank])

    def walk(node, path: tuple, rank: int):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,), rank) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),), rank) for i, v in enumerate(node))
        if isinstance(node, np.ndarray):
            node = torch.from_numpy(node)
        return shard(path, node, rank) if isinstance(node, torch.Tensor) else node

    return [walk(params, (), rank) for rank in range(tp)]
