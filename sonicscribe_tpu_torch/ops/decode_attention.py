"""Decode attention: one query position per slot against its KV cache.

Port of the TPU kernel ``sonicscribe_tpu/ops/decode_attention.py``
(``flash_decode_attention``). ``decode_attention`` launches the
hand-written CUDA kernel ``csrc/decode_attention.cu`` for tensors on the
card and runs ``decode_attention_plain`` for tensors on the CPU; there is
no other fallback. Unlike the Pallas kernel it takes any cache length M.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from sonicscribe_tpu_torch.ops import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


@functools.cache
def _lib():
    fn = _build.load("decode_attention").decode_attention
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, L, L, L, L, ctypes.c_float, P]
    fn.restype = ctypes.c_int
    return fn


def decode_attention_cuda(q, k_cache, v_cache, lens) -> torch.Tensor:
    """Launch the CUDA kernel; shapes as decode_attention_plain. Raises on
    any input the kernel does not take, and on a failed launch."""
    S, nh, hd = q.shape
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
    if q.stride(2) != 1 or q.stride(1) != hd:
        raise ValueError("q rows must be contiguous [nh, hd]")
    if k_cache.stride() != v_cache.stride() or k_cache.stride(3) != 1:
        raise ValueError("k/v caches must share strides with a contiguous last dim")
    out = torch.empty((S, nh * hd), device=q.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        out.data_ptr(), _DTYPES[q.dtype], S, M, nkv, nh // nkv, hd,
        q.stride(0), k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        1.0 / math.sqrt(hd), stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
    _build.launch_counts["decode_attention"] += 1
    return out


def decode_attention(q, k_cache, v_cache, lens) -> torch.Tensor:
    """ctx [S, nh*hd] float32: the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lens)
    return decode_attention_cuda(q, k_cache, v_cache, lens)
