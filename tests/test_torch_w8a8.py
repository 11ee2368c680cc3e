"""The W8A8 designs' arithmetic on the CPU, with no card: the launch shapes
of the cluster split-K design under its integer policy and of the s8
tensor-core design, the routing between them, and numpy emulations of the
two kernels' byte handling (the `__dp4a` lane grouping of
csrc/int8_matmul.cu `regroup`, and the mma B fragment of csrc/s8_mma.cuh
`load_b` with xq in `xq_slot` order), each held to the plain int32
product and, end to end, to the JAX package's matmul_w8a8. The plain
version under a given row_amax (a tensor-parallel rank's row scale):
with each row's own max it is the plain version without one, with a
larger max the JAX recipe at that scale, and a row_amax of the wrong
dtype, shape or device raises."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicscribe_tpu.ops import quant as jq
from sonicscribe_tpu_torch.ops import _build
from sonicscribe_tpu_torch.ops import int8_matmul as im
from sonicscribe_tpu_torch.ops.quant import quantize_tensor

NANO_DEC = [(2048, 3072), (2048, 2048), (2048, 11008), (5504, 2048)]
TINY_DEC = [(128, 256), (128, 128), (128, 512), (256, 128)]


# ---------------------------------------------------------------- launch shapes


@pytest.mark.parametrize("K,N", NANO_DEC + TINY_DEC)
def test_cluster_shape_integer_policy_covers_every_row_and_column_once(K, N):
    """Under W8A8's policy (1 byte of staged x per k) the grid covers every
    row of q and every output element exactly once, no CTA without rows,
    each CTA's shared memory within the card's, at B 1-8."""
    for B in range(1, 9):
        s = im.w8a8_cluster_shape(B, K, N)
        assert s.rows == {1: 1, 2: 2, 3: 4, 4: 4}.get(B, 8)
        assert s.cluster in (1, 2, 4, 8, 16) and s.k_per_cta % 16 == 0
        assert im.cluster_smem(1, s.rows, s.cluster, s.k_per_cta, 1) <= im.MAX_SMEM
        assert s.grid == (-(-N // 128), -(-B // s.rows), s.cluster)
        rows = np.zeros(K, int)
        for rank in range(s.cluster):
            lo, hi = rank * s.k_per_cta, min(K, (rank + 1) * s.k_per_cta)
            assert hi > lo, (B, K, N, s)
            rows[lo:hi] += 1
        assert (rows == 1).all()
        cols = np.zeros((B, N), int)
        for bx in range(s.grid[0]):
            for by in range(s.grid[1]):
                cols[by * s.rows: (by + 1) * s.rows, bx * 128: (bx + 1) * 128] += 1
        assert (cols == 1).all()


def test_w8a8_cluster_shape_at_nano_decode_rows():
    """Pinned, the H100 slice-table A/B's choice (PERF.md): W8A8 slices of
    at most 512 rows of q per CTA up to 4 x rows (twice W8A16's), so qkv, o
    and gate_up take clusters of 4 where W8A16 takes 8; down's K = 5504
    still needs 16 CTAs of 352 rows."""
    got = [[im.w8a8_cluster_shape(B, K, N)[1:3] for K, N in NANO_DEC] for B in (1, 2, 3)]
    assert got == [[(4, 512), (4, 512), (4, 512), (16, 352)]] * 3
    assert im.W8A8_CLUSTER_ROWS_PER_CTA == {r: 2 * v for r, v in im.CLUSTER_ROWS_PER_CTA.items()}


def test_cluster_smem_counts_one_byte_per_staged_k():
    """The integer policy stages x as int8: a quarter of the float
    policies' x bytes, the same sums and slots."""
    assert im.cluster_smem(1, 8, 16, 352, 1) == 8 * 352 + 4 * 24 * 8 * 128
    assert im.cluster_smem(1, 8, 16, 352) - im.cluster_smem(1, 8, 16, 352, 1) == 3 * 8 * 352


@pytest.mark.parametrize("R,reg_rows", [(1, 8), (1, 4), (4, 8), (4, 4)])
def test_lane_steps_cover_the_slice_once(R, reg_rows):
    """csrc/cluster_splitk.cuh: k-lane kl's piece i of the pass at `base`
    is row base + (i // R * 32 + kl) * R + i % R, and a step of R rows runs
    where its first row lies in the slice. Over the 32 k-lanes and the
    passes every row of a slice is loaded and used exactly once, for slices
    of every length the launch shapes give (multiples of 4 up to the
    slice)."""
    for rows in (4, 16, 100, 128, 256, 352, 512, 1024):
        used = np.zeros(rows, int)
        for base in range(0, rows, reg_rows * 32):
            for kl in range(32):
                for s in range(reg_rows // R):
                    first = base + (s * 32 + kl) * R
                    if first < rows:
                        used[first: first + R] += 1
                        assert first + R <= rows  # a step never straddles the slice's end
        assert (used == 1).all(), (R, reg_rows, rows)


@pytest.mark.parametrize("B", [9, 16, 17, 32, 64, 128, 256, 1536])
def test_s8_mma_shape_covers_every_row_once_for_w8a8(B):
    """The W8A8 mma design's splits cover every row of K exactly once, each
    a whole number of stages that fits a block's shared memory (one plane
    of quantised x), with about one block per SM."""
    for K, N in NANO_DEC:
        splits, kps = im.s8_mma_shape(B, K, N, 132, im.W8A8_MMA_MAX_K_PER_SPLIT)
        assert kps % 64 == 0 and 0 < kps <= im.W8A8_MMA_MAX_K_PER_SPLIT
        rows = np.zeros(K, int)
        for s in range(splits):
            assert s * kps < K  # no empty split
            rows[s * kps: min(K, (s + 1) * kps)] += 1
        assert (rows == 1).all()
        tiles = N // 128 * -(-B // 64)
        fit = -(-K // im.W8A8_MMA_MAX_K_PER_SPLIT)
        assert splits == 1 or tiles * splits <= max(132, tiles * fit) + tiles


def test_w8a8_max_k_per_split_fits_a_block():
    """One plane of quantised x (64 rows, 16 bytes of padding) and the
    4-stage ring of 64 x 144 bytes fit the block's shared memory, with 1 KB
    kept for the static arrays beside it (csrc/s8_mma.cuh
    max_k_per_split(1))."""
    kps = im.W8A8_MMA_MAX_K_PER_SPLIT
    assert kps % 64 == 0
    assert 64 * (kps + 16) + 4 * 64 * 144 <= 232448 - 1024 < 64 * (kps + 64 + 16) + 4 * 64 * 144


def test_w8a8_routes_by_its_measured_threshold():
    """From W8A8_MMA_MIN_ROWS rows the s8 tensor cores, below it the cluster
    split-K design; N not a whole number of 128-column tiles stays on the
    cluster design at any B."""
    T = im.W8A8_MMA_MIN_ROWS
    assert T == 5
    for B in range(1, 300):
        for _, N in NANO_DEC + TINY_DEC:
            assert im.w8a8_uses_mma(B, N) == (B >= T)
        assert not im.w8a8_uses_mma(B, 2064)
    assert not im.w8a8_uses_mma(T - 1, 2048) and im.w8a8_uses_mma(T, 2048)


def test_w8a8_entries_launch_nothing_on_the_cpu():
    """On the CPU the W8A8 entry runs the plain version at any B: no kernel,
    no counter (the mma counter included)."""
    rng = np.random.default_rng(0)
    qt = quantize_tensor(torch.from_numpy(rng.standard_normal((2, 256, 128)).astype(np.float32)))
    for B in (1, im.W8A8_MMA_MIN_ROWS, 64):
        x = torch.from_numpy(rng.standard_normal((B, 256)).astype(np.float32))
        before = dict(_build.launch_counts)
        im.int8_matmul_w8a8(x, qt["q"], qt["scale"], 1)
        assert _build.launch_counts == before


# ---------------------------------------------------------------- row_amax


def _row_amax_case(dtype, seed=4, B=5, K=96, N=64):
    rng = np.random.default_rng(seed)
    qt = quantize_tensor(torch.from_numpy(rng.standard_normal((2, K, N)).astype(np.float32))
                         * 0.05)
    x = torch.from_numpy((rng.standard_normal((B, K)) * 2.0).astype(np.float32)).to(dtype)
    return x, qt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_plain_with_each_rows_own_amax_is_the_plain_version(dtype):
    """row_amax = each row's own max|x| (float32, exact for bf16 x): the
    same bits as the plain version without one, on CPU and through the
    entry."""
    x, qt = _row_amax_case(dtype)
    want = im.int8_matmul_w8a8_plain(x, qt["q"], qt["scale"], 1)
    amax = x.float().abs().amax(-1)
    assert torch.equal(im.int8_matmul_w8a8_plain(x, qt["q"], qt["scale"], 1, amax), want)
    assert torch.equal(im.int8_matmul_w8a8(x, qt["q"], qt["scale"], 1, amax), want)
    xq, sx = im.quantize_activations(x, amax)
    assert torch.equal(xq, im.quantize_activations(x)[0])
    assert torch.equal(sx, im.quantize_activations(x)[1])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_w8a8_plain_with_a_larger_amax_is_jaxs_recipe_at_that_scale(dtype):
    """A rank's share of a row holds at most the row's max: with row_amax
    above each row's own max (the other shares' max), the plain version is
    the JAX package's recipe (ops/quant.py:matmul_w8a8) with that value as
    the row's max, bit for bit: sx = max(amax, 1e-8) / 127, xq =
    clip(round(x / sx)), the int32 product * sx * scale. A zero row takes
    the 1e-8 floor."""
    rng = np.random.default_rng(7)
    K, N, B = 128, 64, 4
    qt = jq.quantize_tensor(jnp.asarray(rng.standard_normal((K, N)), jnp.float32) * 0.02)
    x = jnp.asarray(rng.standard_normal((B, K)), dtype).at[3].set(0.0)
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1) * jnp.asarray([1.0, 1.5, 7.25, 1.0])
    amax = amax.at[3].set(0.0)
    sx = jnp.maximum(amax[:, None], 1e-8) / 127.0
    xq = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    acc = jnp.matmul(xq.astype(jnp.int32), qt["q"].astype(jnp.int32))
    want = np.asarray((acc.astype(jnp.float32) * sx * qt["scale"][0]).astype(dtype), np.float32)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    xt = torch.from_numpy(np.array(xf)).to(tdtype)
    q = torch.from_numpy(np.array(qt["q"]))[None]
    scale = torch.from_numpy(np.array(qt["scale"]))[None]
    got = im.int8_matmul_w8a8_plain(xt, q, scale, 0, torch.from_numpy(np.array(amax)))
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not got[3].any()
    # and it is not the row's own scale: rows 1 and 2 moved
    own = im.int8_matmul_w8a8_plain(xt, q, scale, 0)
    assert torch.equal(got[0], own[0]) and not torch.equal(got[2], own[2])


@pytest.mark.parametrize("bad, error, match", [
    (lambda x: x.abs().amax(-1).double(), TypeError, "float32"),
    (lambda x: x.abs().amax(-1, keepdim=True), ValueError, r"\[5\]"),
    (lambda x: x.abs().amax(-1)[:4], ValueError, r"\[5\]"),
    (lambda x: torch.empty(5, device="meta"), ValueError, "must be on cpu"),
])
def test_w8a8_refuses_a_bad_row_amax(bad, error, match):
    """row_amax of another dtype, shape or device raises, in the plain
    version and the entry; matmul_w8a8 wants x's leading shape."""
    from sonicscribe_tpu_torch.ops.quant import matmul_w8a8

    x, qt = _row_amax_case(torch.float32)
    for fn in (im.int8_matmul_w8a8_plain, im.int8_matmul_w8a8):
        with pytest.raises(error, match=match):
            fn(x, qt["q"], qt["scale"], 1, bad(x))
    w = {"q": qt["q"], "scale": qt["scale"], "layer": 1}
    with pytest.raises(ValueError, match="row_amax"):
        matmul_w8a8(x[None], w, row_amax=x.abs().amax(-1))
    got = matmul_w8a8(x[None], w, row_amax=x.abs().amax(-1)[None])
    assert torch.equal(got[0], im.int8_matmul_w8a8_plain(x, qt["q"], qt["scale"], 1))


# ---------------------------------------------------------------- emulations


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: byte n of the result is byte (s >> 4n) & 7 of
    the 8 bytes of y:x."""
    both = (y << 32) | x
    return sum(((both >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n) for n in range(4))


def _bytes_s8(word: int) -> np.ndarray:
    return np.array([word >> (8 * j) & 0xFF for j in range(4)], np.uint8).view(np.int8)


def _word(b) -> int:
    b = np.asarray(b, np.int8).view(np.uint8).astype(np.int64)
    return int(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24)


def _dp4a(a: int, b: int, c: int) -> int:
    return c + int((_bytes_s8(a).astype(np.int64) * _bytes_s8(b).astype(np.int64)).sum())


def _regroup(rows: np.ndarray) -> list:
    """csrc/int8_matmul.cu regroup, emulated: rows k..k+3 of 16 columns
    ([4, 16] int8, each row one 16-byte load) -> per column one word of its
    4 consecutive k."""
    words = [[_word(rows[r, 4 * i: 4 * i + 4]) for i in range(4)] for r in range(4)]
    a, b, c, d = words
    out = [0] * 16
    for i in range(4):
        ab_lo, ab_hi = _byte_perm(a[i], b[i], 0x5140), _byte_perm(a[i], b[i], 0x7362)
        cd_lo, cd_hi = _byte_perm(c[i], d[i], 0x5140), _byte_perm(c[i], d[i], 0x7362)
        out[4 * i + 0] = _byte_perm(ab_lo, cd_lo, 0x5410)
        out[4 * i + 1] = _byte_perm(ab_lo, cd_lo, 0x7632)
        out[4 * i + 2] = _byte_perm(ab_hi, cd_hi, 0x5410)
        out[4 * i + 3] = _byte_perm(ab_hi, cd_hi, 0x7632)
    return out


def _all_bytes(rng, shape) -> np.ndarray:
    """int8 of `shape` (size a multiple of 256) holding every byte value
    equally often, in random order."""
    size = int(np.prod(shape))
    return rng.permutation(np.tile(np.arange(256, dtype=np.uint8), size // 256)).view(
        np.int8).reshape(shape)


def test_dp4a_lane_grouping_gives_the_int32_product():
    """The cluster design's W8A8 step, emulated: four 16-byte rows of q
    regrouped into one word of 4 k per column, one __dp4a per column
    against a word of 4 quantised k of x (value j in byte j, as quant4
    packs it): the plain int32 product, over every byte value of q in
    every row and column position and x at its extremes."""
    rng = np.random.default_rng(0)
    for trial in range(4):
        q_all = _all_bytes(rng, (4, 64))  # each byte value once, at random positions
        xq = rng.integers(-127, 128, 4).astype(np.int8)
        xq[trial] = (-127, 127, 0, -1)[trial]
        for c0 in range(0, 64, 16):
            q = q_all[:, c0: c0 + 16]
            wc = _regroup(q)
            got = [_dp4a(wc[j], _word(xq), 0) for j in range(16)]
            np.testing.assert_array_equal(got, xq.astype(np.int64) @ q.astype(np.int64))


def _ldmatrix_trans_x4(tile: np.ndarray, lane: int) -> list:
    """ldmatrix.sync.aligned.m8n8.x4.trans.b16 on rows 0..31 of a [32, 16]
    int8 tile (lane l gives row l's address), read as 8 16-bit columns:
    register m of `lane` holds 16-bit column lane // 4 of rows 8m + 2t and
    8m + 2t + 1 (t = lane % 4)."""
    c, t = lane // 4, lane % 4
    regs = []
    for m in range(4):
        lo = tile[8 * m + 2 * t, 2 * c: 2 * c + 2]
        hi = tile[8 * m + 2 * t + 1, 2 * c: 2 * c + 2]
        regs.append(_word(np.concatenate([lo, hi])))
    return regs


def _xq_slot(u: int, j: int) -> int:
    return 16 * (u >> 2) + 8 * (u & 1) + 2 * ((u >> 1) & 1) + 4 * j


def _stored(xq_row: np.ndarray) -> np.ndarray:
    """csrc/s8_mma.cuh quantize_row's byte order for one plane: within each
    group of 32 k, rows 4u + 2j and 4u + 2j + 1 at xq_slot(u, j)."""
    out = np.zeros_like(xq_row)
    for g in range(0, len(xq_row), 32):
        for u in range(8):
            for j in range(2):
                out[g + _xq_slot(u, j): g + _xq_slot(u, j) + 2] = xq_row[g + 4 * u + 2 * j:
                                                                         g + 4 * u + 2 * j + 2]
    return out


def _mma_w8a8(xq: np.ndarray, w: np.ndarray) -> np.ndarray:
    """One k step of 32 of the W8A8 mma design on 16 rows of xq [16, 32]
    and 16 columns of q [32, 16], emulated as the warp's registers hold it:
    A by ldmatrix (non-trans) over xq stored in xq_slot order, B by
    load_b (ldmatrix.trans + __byte_perm 0x6420 / 0x7531, q's bytes used as
    they are, S8Plane), mma.sync m16n8k32 s8 x s8 for the even and the odd
    n-tile, and the outputs put back at their columns by the epilogue's
    mapping. -> [16, 16] int32 sums."""
    stored = np.stack([_stored(r) for r in xq])
    out = np.zeros((16, 16), np.int64)
    A = np.zeros((16, 32), np.int64)  # [row, fragment k]
    B = {"e": np.zeros((32, 8), np.int64), "o": np.zeros((32, 8), np.int64)}  # [fragment k, n]
    for lane in range(32):
        gid, t = lane // 4, lane % 4
        a = [_word(stored[gid, 4 * t: 4 * t + 4]), _word(stored[gid + 8, 4 * t: 4 * t + 4]),
             _word(stored[gid, 16 + 4 * t: 20 + 4 * t]),
             _word(stored[gid + 8, 16 + 4 * t: 20 + 4 * t])]
        A[gid, 4 * t: 4 * t + 4] = _bytes_s8(a[0])
        A[gid + 8, 4 * t: 4 * t + 4] = _bytes_s8(a[1])
        A[gid, 16 + 4 * t: 20 + 4 * t] = _bytes_s8(a[2])
        A[gid + 8, 16 + 4 * t: 20 + 4 * t] = _bytes_s8(a[3])
        r = _ldmatrix_trans_x4(w, lane)
        e = [_byte_perm(r[0], r[1], 0x6420), _byte_perm(r[2], r[3], 0x6420)]
        o = [_byte_perm(r[0], r[1], 0x7531), _byte_perm(r[2], r[3], 0x7531)]
        for name, frag in (("e", e), ("o", o)):
            B[name][4 * t: 4 * t + 4, gid] = _bytes_s8(frag[0])
            B[name][16 + 4 * t: 20 + 4 * t, gid] = _bytes_s8(frag[1])
    for name in ("e", "o"):
        C = A @ B[name]  # [16, 8]
        for lane in range(32):
            gid, t4 = lane // 4, lane % 4
            for half in range(2):
                row = gid + 8 * half
                # c0 / c1 of this n-tile are its columns 2 t4, 2 t4 + 1: in q's
                # columns 4 t4 (+1 odd) and 4 t4 + 2 (+1 odd)
                odd = int(name == "o")
                out[row, 4 * t4 + odd] = C[row, 2 * t4]
                out[row, 4 * t4 + 2 + odd] = C[row, 2 * t4 + 1]
    return out


def test_mma_b_fragment_gives_the_int32_product_for_every_byte():
    """The W8A8 mma design's fragments, emulated bit for bit: every byte
    value of q in every position of the 32 x 16 tile over the trials, xq
    in [-127, 127], the int32 sums equal the plain product."""
    rng = np.random.default_rng(1)
    for trial in range(6):
        w = _all_bytes(rng, (32, 16))
        xq = rng.integers(-127, 128, (16, 32)).astype(np.int8)
        xq[trial % 16, :] = 127 if trial % 2 else -127
        np.testing.assert_array_equal(_mma_w8a8(xq, w), xq.astype(np.int64) @ w.astype(np.int64))


def _emulated_cluster_w8a8(x: torch.Tensor, q: np.ndarray, scale: np.ndarray, k_per_cta: int):
    """The cluster design end to end in numpy: quantise (the plain recipe),
    each CTA's slice summed with the dp4a grouping, the slots added in rank
    order, float32(sum) * sx * scale, cast to x's type."""
    xq, sx = (t.numpy() for t in im.quantize_activations(x))
    B, K = xq.shape
    acc = np.zeros((B, q.shape[1]), np.int64)
    for k0 in range(0, K, k_per_cta):
        part = np.zeros_like(acc)
        for k in range(k0, min(K, k0 + k_per_cta), 4):
            for c0 in range(0, q.shape[1], 16):
                wc = _regroup(q[k: k + 4, c0: c0 + 16])
                for b in range(B):
                    xw = _word(xq[b, k: k + 4])
                    part[b, c0: c0 + 16] += [_dp4a(wc[j], xw, 0) for j in range(16)]
        acc += part
    out = (acc.astype(np.float32) * sx) * scale.reshape(-1)
    return torch.from_numpy(out.astype(np.float32)).to(x.dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_emulated_designs_equal_jax_matmul_w8a8(dtype):
    """Both W8A8 designs' integer arithmetic, emulated on tiny's qkv shape
    (K 128, N 256 cut to 32 columns), against the JAX package's
    matmul_w8a8 on the same x and quantised weight: equal outputs."""
    rng = np.random.default_rng(2)
    K, N = 128, 32
    qt = jq.quantize_tensor(jnp.asarray(rng.standard_normal((K, N)), jnp.float32) * 0.02)
    x = jnp.asarray(rng.standard_normal((3, K)), dtype)
    want = np.asarray(jq.matmul_w8a8(x, qt), np.float32)
    q, scale = np.asarray(qt["q"]), np.asarray(qt["scale"])
    xt = torch.from_numpy(np.array(x, np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    got = _emulated_cluster_w8a8(xt, q, scale, k_per_cta=48)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the mma design: 32-k steps of 16-column pieces, int32 sums, then the
    # same epilogue
    xq, sx = (t.numpy() for t in im.quantize_activations(xt))
    acc = np.zeros((16, N), np.int64)
    xq16 = np.zeros((16, K), np.int8)
    xq16[:3] = xq
    for k0 in range(0, K, 32):
        for c0 in range(0, N, 16):
            acc[:, c0: c0 + 16] += _mma_w8a8(xq16[:, k0: k0 + 32], q[k0: k0 + 32, c0: c0 + 16])
    out = (acc[:3].astype(np.float32) * sx) * scale.reshape(-1)
    got = torch.from_numpy(out.astype(np.float32)).to(xt.dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)
