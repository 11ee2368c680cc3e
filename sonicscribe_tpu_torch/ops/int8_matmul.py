"""Int8-weight matrix products: W8A16 (flat and stacked) and W8A8.

Port of the TPU kernels ``sonicscribe_tpu/ops/int8_pallas.py``
(``int8_matmul``, ``int8_matmul_stacked``) and the counterpart of
``ops/quant.py:matmul_w8a8``, which the JAX package leaves to XLA. Each
entry launches the hand-written CUDA kernel ``csrc/int8_matmul.cu`` for
tensors on the card and runs its ``*_plain`` version for tensors on the
CPU; there is no other fallback. Weights keep the JAX layout: q int8
[K, N] (or a stack [L, K, N]) with N contiguous, scale float32 [1, N]
(or [L, 1, N]).

W8A8 quantises x per row inside the CUDA code (the JAX recipe, bit for
bit), so a W8A8 call on the card launches only kernels of
``csrc/int8_matmul.cu``; ``quantize_activations`` is its plain version.
A caller may give each row's max|x| (``row_amax``, float32 [B]): a
tensor-parallel rank, whose x holds its K / tp share of each row, passes
the max over every rank's share (models/glm_asr.py), and each row's scale
is made from that value instead of the row's own.
It has two designs (``w8a8_uses_mma`` picks): decode rows run the
one-launch cluster split-K design with int32 ``__dp4a``
(``w8a8_cluster_shape``); from W8A8_MMA_MIN_ROWS rows a quantise
kernel and the s8 tensor cores (``mma.sync``, the W4A8 design with one
plane, ``s8_mma_shape``).

The W8A16 entries (flat and stacked) have two designs: bf16 x with more
than 8 rows (prefill, the encoder) runs on the tensor cores
(``mma.sync``, ``uses_mma``); decode rows and float32 x run the one-launch
cluster split-K design (``cluster_shape``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from sonicscribe_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_N = 128  # columns per block (csrc/cluster_splitk.cuh kTileN)
CHUNK_K = 128  # W4A8 at decode rows: k rows per staged chunk (csrc/int4_matmul.cu kChunkK)
BLOCKS_PER_SM = 4  # W4A8 at decode rows: split K until the grid holds about this many blocks per SM
MMA_MIN_ROWS = 9  # bf16 x with at least this many rows goes to the tensor cores
# the cluster split-K design (csrc/cluster_splitk.cuh)
CLUSTER_MAX = 16  # CTAs per cluster (kMaxCluster); above 8 a non-portable size
CLUSTER_ROW_ALIGN = 16  # rows of q per CTA are a multiple of this (kRowAlign)
# rows of the weight per CTA that the cluster is sized for, by x rows per
# CTA (an int4 packed row holds two): the fastest of the tables that
# chip_smoke.py times in a decode step replayed on the H100 (PERF.md; it
# also times every cluster size alone). More x rows hold more registers (1
# CTA per SM at 8) and do more FMAs per weight byte, so they take longer
# slices.
CLUSTER_ROWS_PER_CTA = {1: 256, 2: 256, 4: 256, 8: 512}
# W8A8's table: each __dp4a does 4 k, and in a replayed decode step twice
# the W8A16 slices were fastest at 1 and 2 x rows (chip_smoke.py
# slice_table_steps, PERF.md)
W8A8_CLUSTER_ROWS_PER_CTA = {1: 512, 2: 512, 4: 512, 8: 1024}
MAX_SMEM = 232448  # a CTA's shared memory on the H100 (kMaxSmem)
# W8A8 with at least this many rows runs on the s8 tensor cores: where the
# four decode projections' summed time crosses in chip_smoke.py's A/B of
# both designs on the H100 (qkv, o and gate_up cross there too; PERF.md)
W8A8_MMA_MIN_ROWS = 5
# the s8 tensor-core designs (csrc/s8_mma.cuh): block tile and rows per stage
S8_MMA_TILE_M, S8_MMA_TILE_N, S8_MMA_CHUNK_K = 64, 128, 64
W8A8_MMA_MAX_K_PER_SPLIT = 3008  # rows of quantised x a block holds, one plane (max_k_per_split(1))


# ---------------------------------------------------------------- plain


def int8_matmul_plain(x, q, scale) -> torch.Tensor:
    """x [B, K] @ dequant(q [K, N] int8, scale [1, N]) -> [B, N] in
    x.dtype: the product in float32, then the per-column scale, then one
    cast (ops/quant.py:matmul of the JAX package)."""
    return ((x.float() @ q.float()) * scale.reshape(-1)).to(x.dtype)


def int8_matmul_stacked_plain(x, q, scale, layer: int) -> torch.Tensor:
    """int8_matmul_plain on layer `layer` of q [L, K, N], scale [L, 1, N]."""
    return int8_matmul_plain(x, q[layer], scale[layer])


def div127(v: torch.Tensor) -> torch.Tensor:
    """v / 127 as an IEEE division on any device. PyTorch's CUDA division
    by a Python scalar (or any CPU scalar) multiplies by the reciprocal,
    which rounds some values differently from JAX's division (4% of the
    rows' activation scales on the H100, PERF.md); by a tensor on v's
    device it divides."""
    return v / torch.full((), 127.0, device=v.device)


def check_row_amax(name: str, x: torch.Tensor, row_amax) -> None:
    """Raise unless row_amax is None or float32 [B] on x's device (x [B, K])."""
    if row_amax is None:
        return
    if row_amax.dtype != torch.float32:
        raise TypeError(f"{name}: row_amax must be float32, got {row_amax.dtype}")
    if tuple(row_amax.shape) != (x.shape[0],):
        raise ValueError(f"{name}: row_amax must be [{x.shape[0]}] for x {tuple(x.shape)}, "
                         f"got {tuple(row_amax.shape)}")
    if row_amax.device != x.device:
        raise ValueError(f"{name}: row_amax must be on {x.device}, got {row_amax.device}")


def quantize_activations(x, row_amax=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8 of x [B, K] -> (xq int8 [B, K], sx
    float32 [B, 1]): sx = max(max|x|, 1e-8) / 127, xq = clip(round(x /
    sx), -127, 127), round half to even (ops/quant.py:matmul_w8a8), with
    IEEE divisions wherever it runs. A given row_amax (float32 [B]) stands
    in for each row's max|x|."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True) if row_amax is None else row_amax[:, None]
    sx = div127(torch.clamp(amax, min=1e-8))
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def int8_matmul_w8a8_plain(x, q, scale, layer: int, row_amax=None) -> torch.Tensor:
    """x [B, K] with dynamic per-row int8 (each row's scale from row_amax
    where given), times layer `layer` of q [L, K, N] int8 ->
    float32(int32 sums) * sx * scale -> [B, N] in x.dtype. The integer
    product is formed in float64, which holds every sum exactly (|sum| <
    127 * 127 * K < 2**53), on the CPU and the card alike."""
    check_row_amax("int8_matmul_w8a8", x, row_amax)
    xq, sx = quantize_activations(x, row_amax)
    acc = xq.double() @ q[layer].double()
    return (acc.float() * sx * scale[layer].reshape(-1)).to(x.dtype)


# ---------------------------------------------------------------- kernel


def launch_shape(B: int, K: int, N: int, n_sms: int) -> tuple[int, int, int]:
    """-> (rows per block, splits of K, rows of K per split) of the
    streaming kernel with a split-K pass (W4A8 below its tensor-core
    threshold; K is its packed rows K/2). Decode-sized B leaves too few column tiles to
    fill the card, so K is split over blocks until the grid holds about
    BLOCKS_PER_SM blocks per SM, each split at least one chunk."""
    rows = 1 if B == 1 else 2 if B == 2 else 4 if B <= 4 else 8
    tiles = -(-N // TILE_N) * -(-B // rows)
    chunks = -(-K // CHUNK_K)
    splits = min(chunks, max(1, -(-BLOCKS_PER_SM * n_sms // tiles)))
    k_per_split = -(-chunks // splits) * CHUNK_K
    return rows, -(-K // k_per_split), k_per_split


class ClusterShape(NamedTuple):
    rows: int  # x rows per CTA: 1, 2, 4 or 8
    cluster: int  # CTAs per cluster, the splits of K: a power of two, at most CLUSTER_MAX
    k_per_cta: int  # rows of q per CTA, a multiple of CLUSTER_ROW_ALIGN
    grid: tuple[int, int, int]  # (column tiles, row tiles, cluster)


def cluster_smem(halves: int, rows: int, cluster: int, k_per_cta: int, x_bytes: int = 4) -> int:
    """Bytes of shared memory of a cluster split-K CTA: x's rows over its
    slice (`halves`: 2 for int4's two planes; `x_bytes` per value: 4 staged
    as float, 1 quantised for W8A8), the warps' sums and the cluster's
    slots (csrc/cluster_splitk.cuh smem_bytes; q goes to registers)."""
    return x_bytes * halves * rows * k_per_cta + 4 * (8 + cluster) * rows * TILE_N


def cluster_shape(B: int, K: int, N: int, halves: int = 1, cluster: int | None = None,
                  x_bytes: int = 4, table: dict | None = None) -> ClusterShape:
    """The one-launch cluster split-K design's launch for x [B, K @ q's
    rows] against q [K, N] (for int4, K is the packed rows K/2, halves=2).
    Decode-sized B leaves too few column tiles to fill the card, so each
    tile's K is split over the CTAs of one cluster: the smallest cluster
    whose slices hold at most `table` (CLUSTER_ROWS_PER_CTA) rows of the
    weight by x rows (a 1/halves share of that in rows of q), grown further while a CTA
    exceeds the shared memory, but never so far that a CTA would get no
    rows. The SM count does not enter: the table was
    measured on the H100's 132 SMs (64-688 CTAs at nano's shapes).
    `x_bytes` is the policy's staged bytes per x value (1 for W8A8).
    `cluster` forces the cluster size (chip_smoke.py times the others)."""
    rows = 1 if B == 1 else 2 if B == 2 else 4 if B <= 4 else 8
    table = CLUSTER_ROWS_PER_CTA if table is None else table

    def k_per(c):
        return -(-K // (c * CLUSTER_ROW_ALIGN)) * CLUSTER_ROW_ALIGN

    if cluster is None:
        cluster = 1
        while cluster < CLUSTER_MAX and (
                k_per(cluster) > table[rows] // halves
                or cluster_smem(halves, rows, cluster, k_per(cluster), x_bytes) > MAX_SMEM):
            if (2 * cluster - 1) * k_per(2 * cluster) >= K:  # the last CTA would be empty
                break
            cluster *= 2
    return ClusterShape(rows, cluster, k_per(cluster), (-(-N // TILE_N), -(-B // rows), cluster))


def uses_mma(B: int, K: int, dtype: torch.dtype, aligned: bool = True) -> bool:
    """Whether a W8A16 entry runs on the tensor cores: bf16 x with
    more than 8 rows (prefill and encoder rows; decode rows stream the
    weight faster on the CUDA cores, and float32 x keeps full float32
    products). The kernel copies x rows and reads scales in 16-byte pieces,
    so K must be a multiple of 8 and x and scale 16-byte aligned (`aligned`);
    every K of the models is."""
    return dtype == torch.bfloat16 and B >= MMA_MIN_ROWS and K % 8 == 0 and aligned


def w8a8_cluster_shape(B: int, K: int, N: int, cluster: int | None = None) -> ClusterShape:
    """cluster_shape under W8A8's integer policy: 1 byte of staged x per k
    and W8A8_CLUSTER_ROWS_PER_CTA."""
    return cluster_shape(B, K, N, cluster=cluster, x_bytes=1, table=W8A8_CLUSTER_ROWS_PER_CTA)


def w8a8_uses_mma(B: int, N: int) -> bool:
    """Whether a W8A8 launch runs on the s8 tensor cores: from
    W8A8_MMA_MIN_ROWS rows (chip_smoke.py times both designs at nano's four
    decode projections, PERF.md), where N is a whole number of the mma
    design's 128-column tiles (every N of the models is); else the cluster
    split-K design."""
    return B >= W8A8_MMA_MIN_ROWS and N % S8_MMA_TILE_N == 0


def s8_mma_shape(B: int, Kr: int, N: int, n_sms: int, max_k_per_split: int) -> tuple[int, int]:
    """-> (splits, rows per split) of the s8 tensor-core designs (W8A8 on K
    rows, W4A8 on K/2 packed rows). Their blocks hold their quantised x
    rows in shared memory and the card holds about one per SM, so the Kr
    rows are split until the grid is about one block per SM (and each split
    fits: at most max_k_per_split rows), each split a whole number of
    stages."""
    tiles = -(-B // S8_MMA_TILE_M) * -(-N // S8_MMA_TILE_N)
    chunks = -(-Kr // S8_MMA_CHUNK_K)
    splits = max(1, n_sms // tiles, -(-chunks // (max_k_per_split // S8_MMA_CHUNK_K)))
    k_per_split = -(-chunks // min(splits, chunks)) * S8_MMA_CHUNK_K
    return -(-Kr // k_per_split), k_per_split


@functools.cache
def _lib():
    lib = _build.load("int8_matmul")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.int8_matmul_w8a16.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I, P]
    lib.int8_matmul_w8a8.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I, P, P]
    lib.int8_matmul_w8a8_mma.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P, P]
    lib.int8_matmul_w8a16_mma.argtypes = [P, P, P, P, I, I, I, P]
    for fn in (lib.int8_matmul_w8a16, lib.int8_matmul_w8a8, lib.int8_matmul_w8a8_mma,
               lib.int8_matmul_w8a16_mma):
        fn.restype = ctypes.c_int
    return lib


def _check(name, x, q, scale, layer: int) -> tuple[int, int, int]:
    """Validate a launch on the card; -> (B, K, N). Raises on anything the
    kernel does not take."""
    if x.dim() != 2 or q.dim() != 3 or scale.shape != (q.shape[0], 1, q.shape[2]):
        raise ValueError(f"{name}: want x [B, K], q [L, K, N], scale [L, 1, N], got "
                         f"{tuple(x.shape)}, {tuple(q.shape)}, {tuple(scale.shape)}")
    (B, K), (L, Kq, N) = x.shape, q.shape
    if Kq != K or B == 0 or K == 0 or N == 0:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match q {tuple(q.shape)}")
    if N % 16 or -(-B // 8) > 65535:
        raise ValueError(f"{name}: N must be a multiple of 16 and B at most 524280, "
                         f"got B={B}, N={N}")
    if not 0 <= layer < L:
        raise ValueError(f"{name}: layer {layer} out of range for {L} layers")
    for tname, t in (("x", x), ("q", q), ("scale", scale)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: {tname} must be on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    if x.dtype not in _DTYPES or q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{name}: want x float32 or bfloat16, q int8, scale float32, got "
                        f"{x.dtype}, {q.dtype}, {scale.dtype}")
    if q.data_ptr() % 16:
        raise ValueError(f"{name}: q must be 16-byte aligned")
    return B, K, N


@_build.on_tensor_device
def _launch_streaming(x, q, scale, layer: int,
                      cluster: int | None = None) -> tuple[torch.Tensor, int]:
    """The cluster split-K W8A16 design on layer `layer` of a checked
    stack; `cluster` forces a cluster size (chip_smoke.py times them). ->
    (out, cudaError of the launch). Counts nothing."""
    B, K, N = x.shape[0], q.shape[1], q.shape[2]
    shape = cluster_shape(B, K, N, cluster=cluster)
    out = torch.empty((B, N), device=x.device, dtype=x.dtype)
    err = _lib().int8_matmul_w8a16(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], B, K, N,
        layer, shape.rows, shape.cluster, shape.k_per_cta,
        torch.cuda.current_stream(x.device).cuda_stream)
    return out, err


@_build.on_tensor_device
def _launch_w8a8_cluster(x, q, scale, layer: int, cluster: int | None = None,
                         row_amax=None) -> tuple[torch.Tensor, int]:
    """The cluster split-K W8A8 design on layer `layer` of a checked stack
    (and a checked row_amax or None): one launch, no scratch; `cluster`
    forces a cluster size (chip_smoke.py times them). -> (out, cudaError of
    the launch). Counts nothing."""
    B, K, N = x.shape[0], q.shape[1], q.shape[2]
    shape = w8a8_cluster_shape(B, K, N, cluster)
    out = torch.empty((B, N), device=x.device, dtype=x.dtype)
    err = _lib().int8_matmul_w8a8(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], B, K, N,
        layer, shape.rows, shape.cluster, shape.k_per_cta,
        row_amax.data_ptr() if row_amax is not None else None,
        torch.cuda.current_stream(x.device).cuda_stream)
    return out, err


@_build.on_tensor_device
def _launch_w8a8_mma(x, q, scale, layer: int, row_amax=None) -> tuple[torch.Tensor, int]:
    """The s8 tensor-core W8A8 design (N % 128 == 0) on layer `layer` of a
    checked stack (and a checked row_amax or None): a quantise kernel
    writes xq and sx, then the mma kernel (and the split-K pass). -> (out,
    cudaError of the launches). Counts nothing."""
    B, K, N = x.shape[0], q.shape[1], q.shape[2]
    splits, k_per_split = s8_mma_shape(B, K, N, _build.n_sms(x.device), W8A8_MMA_MAX_K_PER_SPLIT)
    out = torch.empty((B, N), device=x.device, dtype=x.dtype)
    partial = (torch.empty((splits, B, N), device=x.device, dtype=torch.int32)
               if splits > 1 else None)
    xq = torch.empty((B, -(-K // S8_MMA_CHUNK_K) * S8_MMA_CHUNK_K), device=x.device,
                     dtype=torch.int8)
    sx = torch.empty((B,), device=x.device)
    err = _lib().int8_matmul_w8a8_mma(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None, xq.data_ptr(), sx.data_ptr(),
        _DTYPES[x.dtype], B, K, N, layer, splits, k_per_split,
        row_amax.data_ptr() if row_amax is not None else None,
        torch.cuda.current_stream(x.device).cuda_stream)
    return out, err


@_build.on_tensor_device
def _launch(name, x, q, scale, layer: int, row_amax=None) -> torch.Tensor:
    """Launch a W8A16 kernel (the tensor-core design where uses_mma says
    so), or the W8A8 design that w8a8_uses_mma picks (its kernels quantise
    x themselves, each row's scale from row_amax where given), on layer
    `layer` of the whole stack. Only torch.empty runs beside the kernels."""
    B, K, N = _check(name, x, q, scale, layer)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    mma = False
    if name == "int8_matmul_w8a8":
        if K % 4:
            raise ValueError(f"{name}: K must be a multiple of 4, got {K}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: x must be 16-byte aligned")
        check_row_amax(name, x, row_amax)
        if row_amax is not None and not row_amax.is_contiguous():
            raise ValueError(f"{name}: row_amax must be contiguous")
        mma = w8a8_uses_mma(B, N)
        out, err = (_launch_w8a8_mma(x, q, scale, layer, row_amax) if mma
                    else _launch_w8a8_cluster(x, q, scale, layer, row_amax=row_amax))
    elif uses_mma(B, K, x.dtype,
                  x.data_ptr() % 16 == 0 and scale[layer].data_ptr() % 16 == 0):
        mma = True
        out = torch.empty((B, N), device=x.device, dtype=x.dtype)
        err = _lib().int8_matmul_w8a16_mma(x.data_ptr(), q[layer].data_ptr(),
                                           scale[layer].data_ptr(), out.data_ptr(), B, K, N,
                                           stream)
    else:
        out, err = _launch_streaming(x, q, scale, layer)
    if err != 0:
        raise RuntimeError(f"{name}{' (mma)' if mma else ''} kernel launch failed: "
                           f"cudaError {err}")
    _build.count_launch(name)
    if mma:
        _build.count_launch("int8_matmul_w8a8_mma" if name == "int8_matmul_w8a8"
                             else "int8_matmul_mma")
    return out


def int8_matmul_cuda(x, q, scale) -> torch.Tensor:
    """Launch a W8A16 kernel on q [K, N], scale [1, N]: the tensor-core
    design where uses_mma says so, else the cluster split-K one."""
    if q.dim() != 2 or scale.dim() != 2:
        raise ValueError(f"int8_matmul: want q [K, N], scale [1, N], got "
                         f"{tuple(q.shape)}, {tuple(scale.shape)}")
    return _launch("int8_matmul", x, q[None], scale[None], 0)


def int8_matmul_stacked_cuda(x, q, scale, layer: int) -> torch.Tensor:
    """int8_matmul_cuda on layer `layer` of the whole stack: one launch."""
    return _launch("int8_matmul_stacked", x, q, scale, layer)


def int8_matmul_w8a8_cuda(x, q, scale, layer: int, row_amax=None) -> torch.Tensor:
    """Launch the W8A8 design that w8a8_uses_mma picks on layer `layer` of
    the whole stack: one cluster split-K kernel at decode rows, else the
    quantise kernel and the s8 tensor cores; x is quantised per row in
    CUDA, with each row's scale from row_amax (float32 [B]) where given."""
    return _launch("int8_matmul_w8a8", x, q, scale, layer, row_amax)


# ---------------------------------------------------------------- entries


def int8_matmul(x, q, scale) -> torch.Tensor:
    """x [B, K] @ dequant(q [K, N], scale [1, N]) -> [B, N] in x.dtype: the
    CUDA kernel for tensors on the card, the plain version on the CPU."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    return int8_matmul_cuda(x, q, scale)


def int8_matmul_stacked(x, q, scale, layer: int) -> torch.Tensor:
    """x [B, K] @ dequant(q [L, K, N], scale [L, 1, N])[layer] -> [B, N]."""
    if x.device.type == "cpu":
        return int8_matmul_stacked_plain(x, q, scale, layer)
    return int8_matmul_stacked_cuda(x, q, scale, layer)


def int8_matmul_w8a8(x, q, scale, layer: int, row_amax=None) -> torch.Tensor:
    """x [B, K] with dynamic per-row int8 @ q [L, K, N][layer] (s8 x s8,
    int32 sums) * sx * scale -> [B, N] in x.dtype. row_amax (float32 [B],
    on x's device) gives each row's max|x| for its scale, where x is a
    share of the row (tensor parallelism); None takes x's own."""
    if x.device.type == "cpu":
        return int8_matmul_w8a8_plain(x, q, scale, layer, row_amax)
    return int8_matmul_w8a8_cuda(x, q, scale, layer, row_amax)
