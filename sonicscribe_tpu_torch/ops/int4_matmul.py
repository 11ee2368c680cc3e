"""Int4-weight matrix products: W4A16 and W4A8, flat and stacked.

Port of the TPU kernels ``sonicscribe_tpu/ops/int4_pallas.py``
(``int4_matmul``, ``int4_matmul_stacked``, ``int4_matmul_w4a8``,
``int4_matmul_w4a8_stacked``). Each entry launches the hand-written CUDA
kernel ``csrc/int4_matmul.cu`` for tensors on the card and runs its
``*_plain`` version for tensors on the CPU; there is no other fallback.

Weights keep the JAX layout: ``packed`` int8 [K/2, N] (or a stack
[L, K/2, N]) with N contiguous, where the low nibble of packed[k, n] holds
weight row k and the high nibble row k + K/2, both sign-extended
(``pack_int4``); the scale is per output column, [1, N] (or [L, 1, N]),
cast to float32 by the entries as JAX's entries cast it.

W4A16 has two designs (``w4a16_uses_mma`` picks): bf16 x from
W4A16_MMA_MIN_ROWS rows runs on the bf16 tensor cores (``mma.sync``, the
nibbles turned into bf16 exactly in registers); decode rows and float32 x
run the one-launch cluster split-K design of the W8A16 decode kernel
(``int8_matmul.cluster_shape``).

For W4A8 the per-row activation quantisation (JAX's ``_quant_acts``, the
recipe of ``quantize_activations``) runs inside the CUDA code, so a W4A8
call on the card launches only kernels of ``csrc/int4_matmul.cu``. Its two
designs (``w4a8_uses_mma`` picks): 5 rows or more run on the s8 tensor
cores (``mma.sync``, after a quantise kernel), fewer stream the weight on
the CUDA cores.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sonicscribe_tpu_torch.ops import _build
from sonicscribe_tpu_torch.ops.int8_matmul import (
    _DTYPES,
    cluster_shape,
    launch_shape,
    quantize_activations,
    s8_mma_shape,
)

N_MULTIPLE = 128  # the JAX gate: N a multiple of 128 (int4_pallas.py:83-96)
W4A8_MMA_MIN_ROWS = 5  # W4A8 with at least this many rows goes to the tensor cores
W4A16_MMA_MIN_ROWS = 3  # bf16 W4A16 with at least this many rows goes to the tensor cores
MMA_TILE_M, MMA_TILE_N = 64, 128  # the mma designs' block tile (csrc kQBM, kQBN)
MMA_CHUNK_K = 64  # packed rows per pipeline stage (kQBK)
MMA_MAX_K_PER_SPLIT = 1472  # packed rows of quantised x a block holds (kQMaxKPerSplit)


# ---------------------------------------------------------------- plain


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """[.., K, N] int8 codes in [-8, 7] -> [.., K/2, N] int8, low nibble =
    row k, high nibble = row k + K/2 (bit-equal to the JAX pack_int4)."""
    k = codes.shape[-2]
    if k % 2:
        raise ValueError(f"pack_int4: K must be even, got {tuple(codes.shape)}")
    lo = codes[..., : k // 2, :].to(torch.int32)
    hi = codes[..., k // 2 :, :].to(torch.int32)
    byte = (lo & 0xF) | ((hi & 0xF) << 4)  # 0..255
    return torch.where(byte > 127, byte - 256, byte).to(torch.int8)


def unpack_halves(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sign-extended nibble planes of packed int8 -> (rows 0..K/2-1, rows
    K/2..K-1), int8."""
    v = packed.to(torch.int32)
    lo = ((v & 0xF) ^ 8) - 8
    hi = v >> 4  # arithmetic: the high nibble, sign-extended
    return lo.to(torch.int8), hi.to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4: [.., K/2, N] -> [.., K, N] int8 codes."""
    return torch.cat(unpack_halves(packed), dim=-2)


def supported(x_shape, packed_shape) -> bool:
    """2-D activations against 2-D packed weights with N a multiple of 128;
    x's K must be exactly twice the packed K/2 (the JAX gate)."""
    if len(x_shape) != 2 or len(packed_shape) != 2:
        return False
    k2, n = packed_shape
    return x_shape[1] == 2 * k2 and n > 0 and n % N_MULTIPLE == 0


def int4_matmul_plain(x, packed, scale) -> torch.Tensor:
    """x [B, K] @ dequant(packed [K/2, N], scale [1, N]) -> [B, N] in
    x.dtype, as the TPU kernel computes it: two half-K float32 products,
    added, times the scale, one cast."""
    lo, hi = unpack_halves(packed)
    k2 = lo.shape[0]
    xf = x.float()
    acc = xf[:, :k2] @ lo.float() + xf[:, k2:] @ hi.float()
    return (acc * scale.reshape(-1)).to(x.dtype)


def int4_matmul_stacked_plain(x, packed, scale, layer: int) -> torch.Tensor:
    """int4_matmul_plain on layer `layer` of packed [L, K/2, N], scale
    [L, 1, N]."""
    return int4_matmul_plain(x, packed[layer], scale[layer])


def int4_matmul_w4a8_plain(x, packed, scale) -> torch.Tensor:
    """x [B, K] with dynamic per-row int8 @ the int4 codes of packed
    [K/2, N] -> float32(int32 sums) * sx * scale -> [B, N] in x.dtype. The
    integer product is formed in float64, which holds every sum exactly
    (|sum| < 127 * 8 * K < 2**53), on the CPU and the card alike."""
    xq, sx = quantize_activations(x)
    acc = xq.double() @ unpack_int4(packed).double()
    return (acc.float() * sx * scale.reshape(-1)).to(x.dtype)


def int4_matmul_w4a8_stacked_plain(x, packed, scale, layer: int) -> torch.Tensor:
    """int4_matmul_w4a8_plain on layer `layer` of the stack."""
    return int4_matmul_w4a8_plain(x, packed[layer], scale[layer])


# ---------------------------------------------------------------- kernel


def w4a8_uses_mma(B: int) -> bool:
    """Whether a W4A8 launch runs on the s8 tensor cores: 5 rows or more.
    Up to 4 rows the streaming kernel's 1- and 4-row tiles are faster (it
    has no wider tile: at 5 to 37 rows its 8-row tile lost to the tensor
    cores, PERF.md); chip_smoke.py times both designs at 1 and 4 rows."""
    return B >= W4A8_MMA_MIN_ROWS


def w4a16_uses_mma(B: int, dtype: torch.dtype, aligned: bool = True) -> bool:
    """Whether a W4A16 launch runs on the bf16 tensor cores: bf16 x with at
    least W4A16_MMA_MIN_ROWS rows (chip_smoke.py times both designs at
    nano's four decode projections, B 1-9, and gate_up to 64; PERF.md).
    The mma design copies x and reads the scale in 16-byte pieces, so K/2
    must be a multiple of 8 and x and scale 16-byte aligned (`aligned`);
    float32 x keeps full float32 products on the CUDA cores."""
    return dtype == torch.bfloat16 and B >= W4A16_MMA_MIN_ROWS and aligned


def w4a16_mma_shape(B: int, K2: int, N: int, n_sms: int) -> tuple[int, int]:
    """-> (splits, packed rows per split) of the W4A16 mma design: the K/2
    packed rows are split until the grid is about one block per SM, each
    split a whole number of stages (its x comes through the ring, so a
    split has no size limit)."""
    tiles = -(-B // MMA_TILE_M) * -(-N // MMA_TILE_N)
    chunks = -(-K2 // MMA_CHUNK_K)
    splits = min(chunks, max(1, n_sms // tiles))
    k_per_split = -(-chunks // splits) * MMA_CHUNK_K
    return -(-K2 // k_per_split), k_per_split


def w4a8_mma_shape(B: int, K2: int, N: int, n_sms: int) -> tuple[int, int]:
    """-> (splits, packed rows per split) of the mma design
    (int8_matmul.s8_mma_shape over the K/2 packed rows, each split at most
    MMA_MAX_K_PER_SPLIT rows: its two planes of quantised x fit a block's
    shared memory)."""
    return s8_mma_shape(B, K2, N, n_sms, MMA_MAX_K_PER_SPLIT)


@functools.cache
def _lib():
    lib = _build.load("int4_matmul")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.int4_matmul_w4a16.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I, P]
    lib.int4_matmul_w4a16_mma.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
    lib.int4_matmul_w4a8.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, I, P]
    lib.int4_matmul_w4a8_mma.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P]
    for fn in (lib.int4_matmul_w4a16, lib.int4_matmul_w4a16_mma, lib.int4_matmul_w4a8,
               lib.int4_matmul_w4a8_mma):
        fn.restype = ctypes.c_int
    return lib


def _check(name, x, packed, scale, layer: int) -> tuple[int, int, int]:
    """Validate a launch on the card; -> (B, K/2, N). Raises on anything
    the kernel does not take."""
    if x.dim() != 2 or packed.dim() != 3 or scale.shape != (packed.shape[0], 1, packed.shape[2]):
        raise ValueError(f"{name}: want x [B, K], packed [L, K/2, N], scale [L, 1, N], got "
                         f"{tuple(x.shape)}, {tuple(packed.shape)}, {tuple(scale.shape)}")
    (B, K), (L, K2, N) = x.shape, packed.shape
    if K % 2 or K != 2 * K2 or B == 0 or K2 == 0:
        raise ValueError(f"{name}: x {tuple(x.shape)} needs an even K twice packed's "
                         f"K/2 {tuple(packed.shape)}")
    if N == 0 or N % N_MULTIPLE or -(-B // 8) > 65535:
        raise ValueError(f"{name}: N must be a multiple of {N_MULTIPLE} and B at most 524280, "
                         f"got B={B}, N={N}")
    if name.startswith("int4_matmul_w4a8") and K2 % 4:
        raise ValueError(f"{name}: K/2 must be a multiple of 4, got {K2}")
    if not 0 <= layer < L:
        raise ValueError(f"{name}: layer {layer} out of range for {L} layers")
    for tname, t in (("x", x), ("packed", packed), ("scale", scale)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: {tname} must be on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    if x.dtype not in _DTYPES or packed.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{name}: want x float32 or bfloat16, packed int8, scale float32, "
                        f"got {x.dtype}, {packed.dtype}, {scale.dtype}")
    if packed.data_ptr() % 16:
        raise ValueError(f"{name}: packed must be 16-byte aligned")
    if name.startswith("int4_matmul_w4a8") and x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned")
    return B, K2, N


@_build.on_tensor_device
def _launch_mma(x, packed, scale, layer: int) -> tuple[torch.Tensor, int]:
    """The tensor-core W4A8 design on layer `layer` of a checked stack: a
    quantise kernel writes xq and sx, then the mma kernel (and the split-K
    pass). -> (out, cudaError of the launches). Counts nothing."""
    B, K2, N = x.shape[0], packed.shape[1], packed.shape[2]
    splits, k_per_split = w4a8_mma_shape(B, K2, N, _build.n_sms(x.device))
    out = torch.empty((B, N), device=x.device, dtype=x.dtype)
    partial = (torch.empty((splits, B, N), device=x.device, dtype=torch.int32)
               if splits > 1 else None)
    xq = torch.empty((B, 2, -(-K2 // MMA_CHUNK_K) * MMA_CHUNK_K), device=x.device,
                     dtype=torch.int8)
    sx = torch.empty((B,), device=x.device)
    err = _lib().int4_matmul_w4a8_mma(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None, xq.data_ptr(), sx.data_ptr(),
        _DTYPES[x.dtype], B, K2, N, layer, splits, k_per_split,
        torch.cuda.current_stream(x.device).cuda_stream)
    return out, err


@_build.on_tensor_device
def _launch_w4a16_mma(x, packed, scale, layer: int) -> tuple[torch.Tensor, int]:
    """The tensor-core W4A16 design (bf16 x, K/2 % 8 == 0, 16-byte aligned
    x and scale) on layer `layer` of a checked stack, and its split-K pass.
    -> (out, cudaError of the launches). Counts nothing."""
    B, K2, N = x.shape[0], packed.shape[1], packed.shape[2]
    splits, k_per_split = w4a16_mma_shape(B, K2, N, _build.n_sms(x.device))
    out = torch.empty((B, N), device=x.device, dtype=x.dtype)
    partial = torch.empty((splits, B, N), device=x.device) if splits > 1 else None
    err = _lib().int4_matmul_w4a16_mma(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None, B, K2, N, layer, splits,
        k_per_split, torch.cuda.current_stream(x.device).cuda_stream)
    return out, err


@_build.on_tensor_device
def _launch_w4a16_streaming(x, packed, scale, layer: int,
                            cluster: int | None = None) -> tuple[torch.Tensor, int]:
    """The cluster split-K W4A16 design on layer `layer` of a checked
    stack: one launch; `cluster` as for int8_matmul._launch_streaming. ->
    (out, cudaError). Counts nothing."""
    B, K2, N = x.shape[0], packed.shape[1], packed.shape[2]
    shape = cluster_shape(B, K2, N, halves=2, cluster=cluster)
    out = torch.empty((B, N), device=x.device, dtype=x.dtype)
    err = _lib().int4_matmul_w4a16(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], B,
        K2, N, layer, shape.rows, shape.cluster, shape.k_per_cta,
        torch.cuda.current_stream(x.device).cuda_stream)
    return out, err


@_build.on_tensor_device
def _launch(name, x, packed, scale, layer: int) -> torch.Tensor:
    """Launch the design that w4a16_uses_mma (W4A16) or w4a8_uses_mma
    (W4A8) picks on layer `layer` of the whole stack. Only torch.empty runs
    beside the kernels."""
    B, K2, N = _check(name, x, packed, scale, layer)
    w4a8 = name.startswith("int4_matmul_w4a8")
    if not w4a8:
        mma = w4a16_uses_mma(B, x.dtype, K2 % 8 == 0 and x.data_ptr() % 16 == 0
                             and scale.data_ptr() % 16 == 0)
        out, err = (_launch_w4a16_mma if mma else _launch_w4a16_streaming)(x, packed, scale, layer)
    elif mma := w4a8_uses_mma(B):
        out, err = _launch_mma(x, packed, scale, layer)
    else:
        # up to 4 rows: split-K over the K/2 packed rows; B=2 takes the 4-row
        # tile (the kernel has no 2-row tile)
        rows, splits, k_per_split = launch_shape(B, K2, N, _build.n_sms(x.device))
        rows = 4 if rows == 2 else rows
        out = torch.empty((B, N), device=x.device, dtype=x.dtype)
        partial = (torch.empty((splits, B, N), device=x.device, dtype=torch.int32)
                   if splits > 1 else None)
        sx = torch.empty((B,), device=x.device) if splits > 1 else None  # read by the split-K pass
        err = _lib().int4_matmul_w4a8(
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            sx.data_ptr() if sx is not None else None, _DTYPES[x.dtype], B, K2, N, layer, rows,
            splits, k_per_split, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}{' (mma)' if mma else ''} kernel launch failed: "
                           f"cudaError {err}")
    _build.count_launch(name)
    if mma:
        _build.count_launch("int4_matmul_w4a8_mma" if w4a8 else "int4_matmul_w4a16_mma")
    return out


def _flat(name, x, packed, scale) -> torch.Tensor:
    """A flat entry: the same C entry on a stack of one, layer 0."""
    if packed.dim() != 2 or scale.dim() != 2:
        raise ValueError(f"{name}: want packed [K/2, N], scale [1, N], got "
                         f"{tuple(packed.shape)}, {tuple(scale.shape)}")
    return _launch(name, x, packed[None], scale[None], 0)


def int4_matmul_cuda(x, packed, scale) -> torch.Tensor:
    """Launch a W4A16 kernel on packed [K/2, N], scale [1, N]: the
    tensor-core design where w4a16_uses_mma says so, else the cluster
    split-K one."""
    return _flat("int4_matmul", x, packed, scale)


def int4_matmul_stacked_cuda(x, packed, scale, layer: int) -> torch.Tensor:
    """int4_matmul_cuda on layer `layer` of the whole stack."""
    return _launch("int4_matmul_stacked", x, packed, scale, layer)


def int4_matmul_w4a8_cuda(x, packed, scale) -> torch.Tensor:
    """Launch the W4A8 kernels (they quantise x per row) on packed [K/2, N],
    scale [1, N]: the tensor-core design where w4a8_uses_mma says so, else
    the CUDA-core one."""
    return _flat("int4_matmul_w4a8", x, packed, scale)


def int4_matmul_w4a8_stacked_cuda(x, packed, scale, layer: int) -> torch.Tensor:
    """int4_matmul_w4a8_cuda on layer `layer` of the whole stack."""
    return _launch("int4_matmul_w4a8_stacked", x, packed, scale, layer)


# ---------------------------------------------------------------- entries


def _flat_scale(scale) -> torch.Tensor:
    return scale.reshape(1, -1).float()


def _stacked_scale(packed, scale) -> torch.Tensor:
    return scale.reshape(packed.shape[0], 1, -1).float()


def int4_matmul(x, packed, scale) -> torch.Tensor:
    """x [B, K] (bf16/f32) @ dequant(packed [K/2, N], scale [1, N]) ->
    [B, N] in x.dtype: the CUDA kernel for tensors on the card, the plain
    version on the CPU."""
    scale = _flat_scale(scale)
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scale)
    return int4_matmul_cuda(x, packed, scale)


def int4_matmul_stacked(x, packed, scale, layer: int) -> torch.Tensor:
    """x [B, K] @ dequant(packed [L, K/2, N], scale [L, 1, N])[layer] ->
    [B, N]; the layer is read by offset from the whole stack."""
    scale = _stacked_scale(packed, scale)
    if x.device.type == "cpu":
        return int4_matmul_stacked_plain(x, packed, scale, layer)
    return int4_matmul_stacked_cuda(x, packed, scale, layer)


def int4_matmul_w4a8(x, packed, scale) -> torch.Tensor:
    """Dynamic per-row s8 activations against the s4 codes of packed
    [K/2, N] (int32 sums) * sx * scale -> [B, N] in x.dtype."""
    scale = _flat_scale(scale)
    if x.device.type == "cpu":
        return int4_matmul_w4a8_plain(x, packed, scale)
    return int4_matmul_w4a8_cuda(x, packed, scale)


def int4_matmul_w4a8_stacked(x, packed, scale, layer: int) -> torch.Tensor:
    """int4_matmul_w4a8 on layer `layer` of packed [L, K/2, N], scale
    [L, 1, N]."""
    scale = _stacked_scale(packed, scale)
    if x.device.type == "cpu":
        return int4_matmul_w4a8_stacked_plain(x, packed, scale, layer)
    return int4_matmul_w4a8_stacked_cuda(x, packed, scale, layer)
