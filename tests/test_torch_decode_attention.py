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
from sonicscribe_tpu_torch.ops.decode_attention import (
    CHUNK_MULTIPLE,
    MAX_SPLITS,
    decode_attention,
    scratch_numel,
    split_shape,
)

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


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("M", [675, 803, 1024])
def test_split_shape_covers_every_position_once(S, M):
    """The kernel's rule (csrc/decode_attention.cu): split s of a slot that
    sees n = min(lens, M - 1) + 1 positions covers [s * chunk, min((s + 1)
    * chunk, n)) and is skipped where s * chunk >= n; its scratch rows are
    ((slot * nkv + head) * splits + s) * g + j."""
    nkv, g, hd = 4, 4, 128
    chunk, splits = split_shape(S, M, nkv, 132)
    assert chunk % 32 == 0 and 1 <= splits <= MAX_SPLITS and chunk * splits >= M
    assert (splits - 1) * chunk < M  # no split that can never see a position
    assert S * nkv * splits >= 88  # the card is filled: 44-88 blocks were the aim at S=1
    assert splits <= 65535 and nkv <= 65535 and S <= 65535  # grid (splits, nkv, S)
    numel = scratch_numel(S, nkv, splits, g, hd)
    ctx_rows = S * nkv * splits * g
    for L in (0, 1, chunk - 1, chunk, chunk + 1, M - 1, M, M + 5):
        n = min(L, M - 1) + 1
        seen = []
        for sp in range(splits):
            if sp * chunk >= n:
                continue
            seen += range(sp * chunk, min((sp + 1) * chunk, n))
        assert seen == list(range(n)), L
    for s in range(S):  # the last (max, denominator) pair of the last split fits
        row = ((s * nkv + nkv - 1) * splits + splits - 1) * g + g - 1
        assert row * hd + hd <= ctx_rows * hd
        assert ctx_rows * hd + row * 2 + 2 <= numel


def test_split_shape_caps_the_splits():
    """Long caches grow the chunk rather than the split count (the merge
    keeps one weight per split in shared memory)."""
    for M in (1, 31, 33, 4096, 100_000):
        chunk, splits = split_shape(1, M, 4, 132)
        assert splits <= MAX_SPLITS and chunk * splits >= M > (splits - 1) * chunk
    assert split_shape(1, 675, 4, 132) == (32, 22)  # 88 blocks for one slot
    assert split_shape(4, 1024, 4, 132) == (64, 16)  # 256 blocks for four


VERIFY_W1 = 9  # the batcher's verify positions a slot (8 drafts + 1)
RING_TILE = 32  # csrc/decode_attention.cu kTile: positions per K/V ring tile


@pytest.mark.parametrize("S", [1, 4, 33])
@pytest.mark.parametrize("M", [83, 803, 1024])
def test_verify_split_shape_covers_every_position_once(S, M):
    """The bf16 verify launch's split (split_shape: occupancy alone, no
    shared-memory cap) under the tensor-core kernel's rules: block (split
    sp, slot) returns at once where sp * chunk passes the slot's last
    query's positions, else walks ceil(n_pos / RING_TILE) ring tiles that
    stay inside its chunk; query j's row writes the splits that start below
    its n_j = min(lens + j, M - 1) + 1 positions, and the merge reads
    ceil(n_j / chunk) of them: every position once, for every query."""
    nkv, g, hd = 4, 4, 128
    chunk, splits = split_shape(S, M, nkv, 132)
    assert chunk % RING_TILE == 0 and CHUNK_MULTIPLE % RING_TILE == 0
    assert 1 <= splits <= MAX_SPLITS and chunk * splits >= M > (splits - 1) * chunk
    rows = S * VERIFY_W1  # (slot, query) rows of the scratch
    numel = scratch_numel(rows, nkv, splits, g, hd)
    last = ((rows * nkv - 1) * splits + splits - 1) * g + g - 1  # the last (row, head)
    assert (last + 1) * hd + (last + 1) * 2 == numel
    for L in (0, 1, chunk - 1, chunk, M - VERIFY_W1, M - 3, M - 1, M, M + 5):
        n_last = min(L + VERIFY_W1 - 1, M - 1) + 1
        for sp in range(splits):
            start = sp * chunk
            if start < n_last:
                n_pos = min(chunk, n_last - start)
                assert -(-n_pos // RING_TILE) * RING_TILE <= chunk
        for j in range(VERIFY_W1):
            n = min(L + j, M - 1) + 1
            written = [sp for sp in range(splits) if sp * chunk < n]
            assert len(written) == -(-n // chunk)  # what the merge reads
            seen = [t for sp in written for t in range(sp * chunk, min((sp + 1) * chunk, n))]
            assert seen == list(range(n)), (L, j)


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).double()


def test_p_in_three_bf16_parts_keeps_the_context_within_the_tolerance():
    """A float64 emulation of the tensor-core verify kernel's second
    product at the chip phase's S 33 shape (nano's heads, M 803, lens past
    M - W1 among them, unit-normal bf16 q, k, v): the products of bf16
    parts of P with bf16 V are exact, so the error against the exact
    context is that of P's parts. One bf16 P is ~300x chip_smoke.py's
    ATTN_TOL (2e-5); hi + lo under it; hi + mid + lo is the float32 p itself
    (3 x 8 significant bits), under 1e-6, which leaves the tolerance to the
    float32 sums."""
    S, M, nh, nkv, hd = 33, 803, 16, 4, 128
    rng = np.random.default_rng(12)
    q = _bf16(rng.standard_normal((S, VERIFY_W1, nh, hd), dtype=np.float32))
    k = _bf16(rng.standard_normal((S, M, nkv, hd), dtype=np.float32))
    v = _bf16(rng.standard_normal((S, M, nkv, hd), dtype=np.float32))
    lens = rng.integers(0, M, S)
    lens[:6] = [0, M - 1, M - 3, M - 9, M - 5, M]
    qg = q.reshape(S, VERIFY_W1, nkv, nh // nkv, hd)
    scores = torch.einsum("sqkgd,smkd->skgqm", qg, k) / np.sqrt(hd)
    qpos = torch.from_numpy(lens)[:, None] + torch.arange(VERIFY_W1)[None, :]
    valid = (torch.arange(M)[None, None, :] <= qpos[:, :, None])[:, None, None]
    scores = torch.where(valid, scores, -torch.inf)
    p = torch.exp(scores - scores.amax(-1, keepdim=True)).float()  # the kernel's float32 p
    denom = p.double().sum(-1, keepdim=True)

    def context(pp):
        return torch.einsum("skgqm,smkd->sqkgd", pp / denom, v)

    exact = context(p.double())
    parts, rest = [], p
    for _ in range(3):
        parts.append(rest.to(torch.bfloat16).float())
        rest = rest - parts[-1]
    errs = [(context(sum(parts[:n]).double()) - exact).abs().max().item() for n in (1, 2, 3)]
    print(f"max abs error of the context, P in 1 / 2 / 3 bf16 parts: {errs}")
    assert errs[0] > 2e-5
    assert errs[2] < 1e-6
