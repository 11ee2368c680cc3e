"""The decode family's per-layer glue, fused (``csrc/decode_glue.cu``).

Three functions that ``models/glm_asr.py``'s decode, dual decode and
verify steps call between their products and attention:

- ``add_rms_norm(h, delta, scale, eps) -> (h_new, hn)``: the residual add
  ``h + delta`` (none where delta is None: layer 0's ln1), then RMSNorm of
  that sum (``rms_norm``);
- ``qkv_rope_kv_write(qkv, bias, cos, sin, rot, k_cache, v_cache, pos) ->
  q``: the QKV bias, the partial NeoX RoPE of q and k (``apply_rope``), and
  the write of k and v into one layer's cache at each row's position,
  dropped where that position is past the cache's end (JAX's
  ``mode="drop"``);
- ``silu_mul(gate_up) -> act``: ``F.silu(gate) * up`` of the gate_up
  product's two halves.

No Pallas kernel stands behind them: XLA fuses this glue in the JAX
package. Each launches its hand-written CUDA kernel for tensors on the
card and runs its plain version, the PyTorch ops it replaces, for tensors
on the CPU; there is no other fallback. The kernels equal the plain
versions bit for bit, but for the RMSNorm's float32 sum of squares, which
they add in another order.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from sonicscribe_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NORM_MAX_D = 12288  # csrc/decode_glue.cu: the row's float32 copy in 48 KB of shared memory
ROPE_MAX_HD = 1024  # one thread a head dim


def rms_norm(x, scale, eps):
    """RMSNorm in float32, rounded once to x's dtype."""
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (out * scale.float()).to(x.dtype)


def apply_rope(x, cos, sin, rot):
    """Partial NeoX RoPE. x: [..., H, head_dim]; cos/sin: [..., rot//2]
    broadcast over heads."""
    x1 = x[..., : rot // 2].float()
    x2 = x[..., rot // 2 : rot].float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    out1 = x1 * c - x2 * s
    out2 = x2 * c + x1 * s
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), x[..., rot:]], dim=-1)


# ---- plain versions ------------------------------------------------------------------------


def add_rms_norm_plain(h, delta, scale, eps):
    """h [..., D], delta like h or None, scale [D] -> (h + delta, its RMSNorm)."""
    if delta is not None:
        h = h + delta
    return h, rms_norm(h, scale, eps)


def _split_heads(qkv, nkv: int, hd: int):
    nh = qkv.shape[-1] // hd - 2 * nkv
    lead = qkv.shape[:-1]
    q = qkv[..., : nh * hd].reshape(*lead, nh, hd)
    k = qkv[..., nh * hd : (nh + nkv) * hd].reshape(*lead, nkv, hd)
    v = qkv[..., (nh + nkv) * hd :].reshape(*lead, nkv, hd)
    return q, k, v


def qkv_rope_kv_write_plain(qkv, bias, cos, sin, rot, k_cache, v_cache, pos):
    """qkv [B, (nh + 2 nkv) hd] (a decode step) or [B, W1, ...] (W1 query
    positions a row, verification); bias [(nh + 2 nkv) hd] or None; cos /
    sin float32 [B, rot//2] or [B, W1, rot//2]; k/v_cache one layer's
    [B, M, nkv, hd]; pos [B] int. Writes k and v of row b's query j at
    position pos[b] + j of the caches where that is < M, in place.
    -> q [B, nh, hd] or [B, W1, nh, hd], rotated."""
    flat = qkv.dim() == 2
    if flat:
        qkv, cos, sin = qkv[:, None], cos[:, None], sin[:, None]
    M, nkv, hd = k_cache.shape[1:]
    if bias is not None:
        qkv = qkv + bias
    q, k, v = _split_heads(qkv, nkv, hd)
    q = apply_rope(q, cos, sin, rot)
    k = apply_rope(k, cos, sin, rot)
    at = pos.to(qkv.device, torch.long)[:, None] + torch.arange(qkv.shape[1],
                                                               device=qkv.device)[None]
    b, j = torch.nonzero(at < M, as_tuple=True)
    k_cache[b, at[b, j]] = k[b, j].to(k_cache.dtype)
    v_cache[b, at[b, j]] = v[b, j].to(v_cache.dtype)
    return q[:, 0] if flat else q


def silu_mul_plain(gate_up):
    """gate_up [..., 2F] = [gate | up] -> silu(gate) * up [..., F]."""
    gate, up = torch.chunk(gate_up, 2, dim=-1)
    return F.silu(gate) * up


# ---- the CUDA kernels ----------------------------------------------------------------------


@functools.cache
def _lib():
    lib = _build.load("decode_glue")
    P, I, L, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.add_rms_norm.argtypes = [P, P, P, P, P, I, I, I, Fl, P]
    lib.qkv_rope_kv_write.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, L, L, L, P]
    lib.silu_mul.argtypes = [P, P, I, I, I, I, P]
    lib.add_rms_norm.restype = lib.qkv_rope_kv_write.restype = lib.silu_mul.restype = ctypes.c_int
    return lib


def _check(name: str, like: torch.Tensor, **tensors) -> None:
    """Raise unless every tensor (None skipped) lies on like's card with
    like's dtype, float32 or bf16, and is contiguous."""
    if like.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {like.dtype}")
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device != like.device or t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} must be on {like.device}, got {t.device}")
        if t.dtype != like.dtype:
            raise TypeError(f"{name}: {arg} must be {like.dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _done(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    _build.count_launch(name)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@_build.on_tensor_device
def add_rms_norm_cuda(h, delta, scale, eps):
    """The kernel; arguments and result as add_rms_norm_plain's. With no
    delta, h_new is h itself."""
    D = h.shape[-1]
    _check("add_rms_norm", h, h=h, delta=delta, scale=scale)
    if (delta is not None and delta.shape != h.shape) or scale.shape != (D,) or D > NORM_MAX_D:
        raise ValueError(f"add_rms_norm: unsupported shapes h {tuple(h.shape)}, delta "
                         f"{None if delta is None else tuple(delta.shape)}, scale "
                         f"{tuple(scale.shape)}")
    h_new = h if delta is None else torch.empty_like(h)
    hn = torch.empty_like(h)
    err = _lib().add_rms_norm(h.data_ptr(), None if delta is None else delta.data_ptr(),
                              scale.data_ptr(), h_new.data_ptr(), hn.data_ptr(),
                              _DTYPES[h.dtype], h.numel() // D, D, eps, _stream(h))
    _done("add_rms_norm", err)
    return h_new, hn


@_build.on_tensor_device
def qkv_rope_kv_write_cuda(qkv, bias, cos, sin, rot, k_cache, v_cache, pos):
    """The kernel; arguments and result as qkv_rope_kv_write_plain's."""
    flat = qkv.dim() == 2
    B, W1 = qkv.shape[0], 1 if flat else qkv.shape[1]
    _check("qkv_rope_kv_write", qkv, qkv=qkv, bias=bias)
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape or k_cache.stride() != v_cache.stride():
        raise ValueError(f"qkv_rope_kv_write: k/v caches must share a [B, M, nkv, hd] shape and "
                         f"strides, got {tuple(k_cache.shape)} and {tuple(v_cache.shape)}")
    _, M, nkv, hd = k_cache.shape
    n = qkv.shape[-1]
    nh = n // hd - 2 * nkv
    half = rot // 2
    table = (B, half) if flat else (B, W1, half)
    if (k_cache.shape[0] != B or n % hd or nh < 1 or rot % 2 or rot > hd or hd > ROPE_MAX_HD
            or (bias is not None and bias.shape != (n,)) or cos.shape != table
            or sin.shape != table):
        raise ValueError(f"qkv_rope_kv_write: unsupported shapes qkv {tuple(qkv.shape)}, cos "
                         f"{tuple(cos.shape)}, cache {tuple(k_cache.shape)}, rot {rot}")
    for arg, t, dtype in (("cos", cos, torch.float32), ("sin", sin, torch.float32),
                          ("k_cache", k_cache, qkv.dtype), ("v_cache", v_cache, qkv.dtype),
                          ("pos", pos, torch.int32)):
        if t.device != qkv.device or t.dtype != dtype:
            raise TypeError(f"qkv_rope_kv_write: {arg} must be {dtype} on {qkv.device}, got "
                            f"{t.dtype} on {t.device}")
    if not (cos.is_contiguous() and sin.is_contiguous() and pos.is_contiguous()
            and pos.shape == (B,) and k_cache.stride(3) == 1):
        raise ValueError("qkv_rope_kv_write: cos, sin and pos [B] must be contiguous, the "
                         "caches' last dim too")
    q = torch.empty((*qkv.shape[:-1], nh, hd), device=qkv.device, dtype=qkv.dtype)
    err = _lib().qkv_rope_kv_write(
        qkv.data_ptr(), None if bias is None else bias.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        _DTYPES[qkv.dtype], B * W1, W1, M, nh, nkv, hd, half, k_cache.stride(0),
        k_cache.stride(1), k_cache.stride(2), _stream(qkv))
    _done("qkv_rope_kv_write", err)
    return q


@_build.on_tensor_device
def silu_mul_cuda(gate_up):
    """The kernel; argument and result as silu_mul_plain's."""
    _check("silu_mul", gate_up, gate_up=gate_up)
    two_f = gate_up.shape[-1]
    if two_f % 2:
        raise ValueError(f"silu_mul: an odd last dim {two_f}")
    act = torch.empty((*gate_up.shape[:-1], two_f // 2), device=gate_up.device,
                      dtype=gate_up.dtype)
    err = _lib().silu_mul(gate_up.data_ptr(), act.data_ptr(), _DTYPES[gate_up.dtype],
                          gate_up.numel() // two_f, two_f // 2, _build.n_sms(gate_up.device),
                          _stream(gate_up))
    _done("silu_mul", err)
    return act


# ---- dispatch ------------------------------------------------------------------------------


def add_rms_norm(h, delta, scale, eps):
    """(h + delta, RMSNorm of it; h itself and its norm where delta is
    None): the CUDA kernel for tensors on the card, the plain version for
    tensors on the CPU."""
    if h.device.type == "cpu":
        return add_rms_norm_plain(h, delta, scale, eps)
    return add_rms_norm_cuda(h, delta, scale, eps)


def qkv_rope_kv_write(qkv, bias, cos, sin, rot, k_cache, v_cache, pos):
    """q rotated, k and v written into the caches in place (see
    qkv_rope_kv_write_plain): the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU."""
    if qkv.device.type == "cpu":
        return qkv_rope_kv_write_plain(qkv, bias, cos, sin, rot, k_cache, v_cache, pos)
    return qkv_rope_kv_write_cuda(qkv, bias, cos, sin, rot, k_cache, v_cache, pos)


def silu_mul(gate_up):
    """silu(gate) * up: the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU."""
    if gate_up.device.type == "cpu":
        return silu_mul_plain(gate_up)
    return silu_mul_cuda(gate_up)
