"""Decode attention: one query position per slot against its KV cache;
verify attention: W1 query positions per slot.

``decode_attention`` is the port of the TPU kernel
``sonicscribe_tpu/ops/decode_attention.py`` (``flash_decode_attention``).
``verify_attention`` is the attention of the JAX package's verify step
(``models/glm_asr.py:verify_step``, which XLA computes there): query j of
slot s sees the positions <= lens[s] + j. Each launches the hand-written
CUDA kernel ``csrc/decode_attention.cu`` for tensors on the card and runs
its plain version for tensors on the CPU; there is no other fallback.
Unlike the Pallas kernel they take any cache length M.

The kernel splits the cache positions over blocks (split-KV) and merges
the splits in a second pass; ``split_shape`` picks the split (for W1 > 1
``verify_split_shape``, whose chunk fits the shared-memory stage) and
``scratch_numel`` sizes the merge's float32 scratch.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from sonicscribe_tpu_torch.ops import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCKS_PER_SM = 2  # aim: about this many split blocks per SM
CHUNK_MULTIPLE = 32  # positions per split: a multiple of one pass (8 groups x 4)
MAX_SPLITS = 128  # csrc/decode_attention.cu kMaxSplits
STAGE_BYTES = 80 * 1024  # csrc/decode_attention.cu kMaxStageBytes: K and V of a staged chunk


def decode_attention_plain(q, k_cache, v_cache, lens) -> torch.Tensor:
    """The masked decode attention of the JAX package
    (models/glm_asr.py:_masked_decode_attention), in float32.

    q [S, nh, hd]; k/v_cache [S, M, nkv, hd] holding the current token at
    lens[s]; lens [S] int -> ctx [S, nh*hd] float32. Slot s attends to the
    positions <= lens[s] (all M where lens[s] >= M: the write was dropped).
    """
    S, nh, hd = q.shape
    M, nkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(S, nkv, nh // nkv, hd).float()
    scores = torch.einsum("skgd,smkd->skgm", qg, k_cache.float()) * (
        1.0 / math.sqrt(hd)
    )
    kpos = torch.arange(M, device=q.device)
    valid = kpos[None, :] <= lens.to(q.device, torch.long)[:, None]  # [S, M]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("skgm,smkd->skgd", attn, v_cache.float()).reshape(S, nh * hd)


def verify_attention_plain(q, k_cache, v_cache, lens) -> torch.Tensor:
    """The masked attention of the JAX package's verify step
    (models/glm_asr.py:verify_step's layer body), in float32.

    q [S, W1, nh, hd]; k/v_cache [S, M, nkv, hd] holding this step's K/V at
    lens[s] + j; lens [S] int -> ctx [S, W1, nh*hd] float32. Query j of
    slot s attends to the positions <= lens[s] + j (all M past the end).
    """
    S, W1, nh, hd = q.shape
    M, nkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(S, W1, nkv, nh // nkv, hd).float()
    scores = torch.einsum("sqkgd,smkd->skgqm", qg, k_cache.float()) * (1.0 / math.sqrt(hd))
    qpos = lens.to(q.device, torch.long)[:, None] + torch.arange(W1, device=q.device)[None, :]
    valid = torch.arange(M, device=q.device)[None, None, :] <= qpos[:, :, None]  # [S, W1, M]
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("skgqm,smkd->sqkgd", attn, v_cache.float()).reshape(S, W1, nh * hd)


def split_shape(S: int, M: int, nkv: int, n_sms: int) -> tuple[int, int]:
    """-> (chunk, splits): split `s` of every (slot, KV head) covers the
    positions [s * chunk, min((s + 1) * chunk, n)) of a slot that sees n =
    min(lens, M - 1) + 1 of them, and a split that starts at or past n is
    skipped. The chunk is the smallest multiple of CHUNK_MULTIPLE that
    gives S * nkv * splits about BLOCKS_PER_SM blocks per SM, and no more
    than MAX_SPLITS splits; the grid is (splits, nkv, S)."""
    per_head = max(1, -(-BLOCKS_PER_SM * n_sms // (S * nkv)))
    chunk = max(-(-M // per_head), -(-M // MAX_SPLITS))
    chunk = -(-chunk // CHUNK_MULTIPLE) * CHUNK_MULTIPLE
    return chunk, -(-M // chunk)


def verify_split_shape(S: int, W1: int, M: int, nkv: int, hd: int, esize: int,
                       n_sms: int) -> tuple[int, int]:
    """-> (chunk, splits) of a verify launch: split_shape's at W1 = 1 (the
    decode kernel, bit for bit); above, its chunk cut to the largest
    multiple of CHUNK_MULTIPLE whose K and V rows fit STAGE_BYTES, so that
    the kernel stages each split in shared memory once for all W1 queries
    (the uncut split where that would pass MAX_SPLITS)."""
    chunk, splits = split_shape(S, M, nkv, n_sms)
    cap = STAGE_BYTES // (2 * hd * esize) // CHUNK_MULTIPLE * CHUNK_MULTIPLE
    if W1 == 1 or cap < CHUNK_MULTIPLE or chunk <= cap or -(-M // cap) > MAX_SPLITS:
        return chunk, splits
    return cap, -(-M // cap)


def scratch_numel(S: int, nkv: int, splits: int, g: int, hd: int) -> int:
    """float32 scratch of one launch: each split's unnormalised context
    [S, nkv, splits, g, hd], then its (max, denominator) [S, nkv, splits, g, 2].
    A verify launch has S * W1 rows."""
    return S * nkv * splits * g * (hd + 2)


@functools.cache
def _lib():
    fn = _build.load("decode_attention").attention
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, L, L, L, L, L, ctypes.c_float, I, I, P]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(q, k_cache, v_cache, lens) -> tuple[int, int, int]:
    """Raise on any input the kernel does not take; q [S, W1, nh, hd].
    -> (M, nkv, g)."""
    S, _, nh, hd = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"k/v caches must share a [S, M, nkv, hd] shape, got "
                         f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}")
    _, M, nkv, hd_kv = k_cache.shape
    if k_cache.shape[0] != S or hd_kv != hd or nh % nkv or nh // nkv > 8 or hd > 256:
        raise ValueError(
            f"unsupported shapes q {tuple(q.shape)}, cache {tuple(k_cache.shape)}"
        )
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache), ("lens", lens)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if lens.dtype != torch.int32 or lens.shape != (S,) or not lens.is_contiguous():
        raise TypeError(f"lens must be a contiguous int32 [S], got {lens.dtype} "
                        f"{tuple(lens.shape)}")
    if q.stride(3) != 1 or q.stride(2) != hd:
        raise ValueError("q rows must be contiguous [nh, hd]")
    if k_cache.stride() != v_cache.stride() or k_cache.stride(3) != 1:
        raise ValueError("k/v caches must share strides with a contiguous last dim")
    return M, nkv, nh // nkv


def _launch(name: str, q, k_cache, v_cache, lens) -> torch.Tensor:
    """One launch of the kernel on q [S, W1, nh, hd] (checked; the split
    from verify_split_shape, split_shape's at W1 = 1), counted as `name`
    -> out [S, W1, nh*hd] float32."""
    M, nkv, g = _check_inputs(q, k_cache, v_cache, lens)
    S, W1, nh, hd = q.shape
    chunk, splits = verify_split_shape(S, W1, M, nkv, hd, q.element_size(),
                                       _build.n_sms(q.device))
    out = torch.empty((S, W1, nh * hd), device=q.device, dtype=torch.float32)
    scratch = torch.empty(scratch_numel(S * W1, nkv, splits, g, hd), device=q.device,
                          dtype=torch.float32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), _DTYPES[q.dtype], S, W1, M, nkv, g, hd, q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2), 1.0 / math.sqrt(hd), chunk,
        splits, stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    _build.launch_counts[name] += 1
    return out


def decode_attention_cuda(q, k_cache, v_cache, lens) -> torch.Tensor:
    """Launch the CUDA kernel; shapes as decode_attention_plain. Raises on
    any input the kernel does not take, and on a failed launch."""
    return _launch("decode_attention", q[:, None], k_cache, v_cache, lens)[:, 0]


def verify_attention_cuda(q, k_cache, v_cache, lens) -> torch.Tensor:
    """Launch the CUDA kernel with W1 query positions; shapes as
    verify_attention_plain. Raises on any input the kernel does not take,
    and on a failed launch."""
    return _launch("verify_attention", q, k_cache, v_cache, lens)


def decode_attention(q, k_cache, v_cache, lens) -> torch.Tensor:
    """ctx [S, nh*hd] float32: the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lens)
    return decode_attention_cuda(q, k_cache, v_cache, lens)


def verify_attention(q, k_cache, v_cache, lens) -> torch.Tensor:
    """ctx [S, W1, nh*hd] float32: the CUDA kernel for tensors on the card,
    the plain version for tensors on the CPU."""
    if q.device.type == "cpu":
        return verify_attention_plain(q, k_cache, v_cache, lens)
    return verify_attention_cuda(q, k_cache, v_cache, lens)
