"""Port parity: the plain PyTorch decode attention (the CUDA kernel's
CPU version) vs the JAX package's Pallas kernel in interpret mode and its
masked XLA path, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicscribe_tpu.models.config import DecoderConfig
from sonicscribe_tpu.models.glm_asr import _masked_decode_attention
from sonicscribe_tpu.ops.decode_attention import flash_decode_attention
from sonicscribe_tpu_torch.ops.decode_attention import decode_attention

NH, NKV, HD = 8, 2, 128
TOL = dict(rtol=2e-4, atol=2e-4)  # float32, different summation orders


def _inputs(M, lens, seed=0):
    rng = np.random.default_rng(seed)
    S = len(lens)
    q = (rng.standard_normal((S, NH, HD)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((S, M, NKV, HD)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((S, M, NKV, HD)) * 0.3).astype(np.float32)
    return q, k, v, np.asarray(lens, np.int32)


def _port(q, k, v, lens):
    t = [torch.from_numpy(a) for a in (q, k, v, lens)]
    return decode_attention(*t).numpy()


def _masked(q, k, v, lens):
    M = k.shape[1]
    dec = DecoderConfig(n_heads=NH, n_kv_heads=NKV, head_dim=HD)
    valid = np.arange(M)[None, :] <= lens[:, None]
    return np.asarray(
        _masked_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid), dec
        )
    )


@pytest.mark.parametrize("M", [256, 200])
def test_matches_masked_path(M):
    q, k, v, lens = _inputs(M, [0, 5, 127, 128, M - 1])
    np.testing.assert_allclose(_port(q, k, v, lens), _masked(q, k, v, lens), **TOL)


def test_matches_pallas_kernel():
    q, k, v, lens = _inputs(256, [0, 5, 127, 128, 255], seed=1)
    want = np.asarray(
        flash_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
            interpret=True,
        )
    )
    np.testing.assert_allclose(_port(q, k, v, lens), want, **TOL)


def test_full_cache_sees_every_position():
    """lens >= M (the current token's write was dropped) attends all M
    positions, as the masked path does for a full cache."""
    M = 200
    q, k, v, _ = _inputs(M, [0, 0], seed=2)
    full = np.asarray([M, M + 5], np.int32)
    last = np.asarray([M - 1, M - 1], np.int32)
    np.testing.assert_allclose(_port(q, k, v, full), _port(q, k, v, last), rtol=0, atol=0)
    np.testing.assert_allclose(_port(q, k, v, full), _masked(q, k, v, full), **TOL)


def test_strided_layer_view_of_cache():
    """The decode step hands one layer of the [L, B, M, nkv, hd] cache."""
    M = 200
    q, k, v, lens = _inputs(M, [3, 150], seed=3)
    big_k = torch.zeros((3,) + k.shape)
    big_v = torch.zeros((3,) + v.shape)
    big_k[1], big_v[1] = torch.from_numpy(k), torch.from_numpy(v)
    got = decode_attention(torch.from_numpy(q), big_k[1], big_v[1], torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), _masked(q, k, v, lens), **TOL)
