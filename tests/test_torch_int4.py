"""Port parity for the int4 kernels and the int4 sweep: the plain versions
of ops/int4_matmul.py against the JAX package's int4_pallas (interpret
mode) on the CPU, and the port's bench_int4_matmul sweep against the same
chain composed from the JAX kernels at tiny() decoder widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicscribe_tpu.ops import int4_pallas as j4
from sonicscribe_tpu_torch.models import tiny
from sonicscribe_tpu_torch.models.weights import params_from_jax
from sonicscribe_tpu_torch.ops import _build
from sonicscribe_tpu_torch.ops import int4_matmul as t4
from sonicscribe_tpu_torch.tools import bench_int4_matmul as bench

W16_TOL = 1e-5  # share of max|want|: float32 sums in another order


def _t(a) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor with the same bits."""
    return params_from_jax(np.asarray(a), device="cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _codes(rng, shape):
    return rng.integers(-8, 8, shape).astype(np.int8)  # -8 is a valid nibble


def _assert_w16_close(got, want):
    """float32 sums in another order: W16_TOL of max|want|; in bf16 one
    more bf16 ulp of want for the final rounding."""
    got, want32 = _np(got), np.asarray(want, np.float32)
    tol = W16_TOL * np.abs(want32).max()
    if want.dtype == jnp.bfloat16:
        tol = tol + 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want32), 2.0**-126))) - 7)
    assert got.shape == want32.shape
    assert (np.abs(got - want32) <= tol).all(), float(np.abs(got - want32).max())


# ---------------------------------------------------------------- packing


@pytest.mark.parametrize("shape", [(256, 128), (2048, 384), (3, 128, 256)])
def test_pack_unpack_bit_equal_to_jax(shape):
    rng = np.random.default_rng(sum(shape))
    codes = _codes(rng, shape)
    codes[..., 0, :] = -8
    want = j4.pack_int4(jnp.asarray(codes))
    got = t4.pack_int4(torch.from_numpy(codes))
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(t4.unpack_int4(got).numpy(), np.asarray(j4.unpack_int4(want)))
    np.testing.assert_array_equal(t4.unpack_int4(got).numpy(), codes)


@pytest.mark.parametrize("x_shape,packed_shape", [
    ((8, 2048), (1024, 11008)), ((8, 5504), (2752, 2048)), ((8, 2048), (2048, 11008)),
    ((2, 8, 128), (64, 128)), ((8, 128), (64, 100)),
])
def test_supported_agrees_with_jax(x_shape, packed_shape):
    assert t4.supported(x_shape, packed_shape) == j4.supported(x_shape, packed_shape)


# ---------------------------------------------------------------- products


def _inputs(seed, b, k, n, dtype, layers=None):
    rng = np.random.default_rng(seed)
    shp = (k, n) if layers is None else (layers, k, n)
    packed = j4.pack_int4(jnp.asarray(_codes(rng, shp)))
    sshape = (1, n) if layers is None else (layers, 1, n)
    scale = jnp.asarray(0.02 + 0.01 * rng.random(sshape), jnp.float32)
    x = jnp.asarray(rng.standard_normal((b, k)), dtype) * 0.1
    return x, packed, scale


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("b,k,n", [(1, 256, 384), (5, 128, 512), (16, 384, 128)])
def test_int4_matmul_plain_matches_pallas(dtype, b, k, n):
    x, packed, scale = _inputs(b, b, k, n, dtype)
    want = j4.int4_matmul(x, packed, scale, interpret=True)
    before = dict(_build.launch_counts)
    got = t4.int4_matmul(_t(x), _t(packed), _t(scale))
    assert _build.launch_counts == before  # the CPU runs the plain version
    assert got.dtype == _t(x).dtype
    _assert_w16_close(got, want)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_int4_matmul_stacked_plain_matches_pallas(dtype):
    x, packed, scale = _inputs(7, 4, 256, 256, dtype, layers=3)
    for layer in range(3):
        want = j4.int4_matmul_stacked(x, packed, scale, layer, interpret=True)
        _assert_w16_close(t4.int4_matmul_stacked(_t(x), _t(packed), _t(scale), layer), want)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("b,k,n", [(1, 256, 384), (16, 384, 128), (3, 200, 256)])
def test_int4_matmul_w4a8_plain_equal_to_pallas(dtype, b, k, n):
    """Equal outputs: the activation quantisation is the same float32
    arithmetic and the integer sums are exact on both sides."""
    x, packed, scale = _inputs(b + 1, b, k, n, dtype)
    want = j4.int4_matmul_w4a8(x, packed, scale, interpret=True)
    got = t4.int4_matmul_w4a8(_t(x), _t(packed), _t(scale))
    assert got.dtype == _t(x).dtype
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_int4_matmul_w4a8_stacked_plain_equal_to_pallas(dtype):
    x, packed, scale = _inputs(9, 3, 256, 128, dtype, layers=2)
    for layer in range(2):
        want = j4.int4_matmul_w4a8_stacked(x, packed, scale, layer, interpret=True)
        got = t4.int4_matmul_w4a8_stacked(_t(x), _t(packed), _t(scale), layer)
        np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def test_entries_cast_the_scale_as_jax_does():
    """A bf16 scale of any shape that reshapes to [1, N] / [L, 1, N]."""
    x, packed, scale = _inputs(11, 2, 128, 128, jnp.float32, layers=2)
    scale16 = scale.astype(jnp.bfloat16)
    want = j4.int4_matmul_stacked(x, packed, scale16.reshape(2, -1), 1, interpret=True)
    got = t4.int4_matmul_stacked(_t(x), _t(packed), _t(scale16).reshape(2, -1), 1)
    _assert_w16_close(got, want)
    want = j4.int4_matmul_w4a8(x, packed[0], scale16[0].reshape(-1), interpret=True)
    got = t4.int4_matmul_w4a8(_t(x), _t(packed[0]), _t(scale16[0]).reshape(-1))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# ---------------------------------------------------------------- the sweep


def _jax_sweep(mm_stacked, weights, h, n_layers):
    """The JAX tool's stacked chain (_sweep_pallas), unjitted."""
    for layer in range(n_layers):
        def mm(x, t):
            return mm_stacked(x, t["packed"], t["scale"], layer, interpret=True)

        qkv = mm(h, weights["qkv_w"])
        h = h + 0.01 * mm(qkv[:, : h.shape[1]], weights["o_w"])
        gate, up = jnp.split(mm(h, weights["gate_up_w"]), 2, axis=-1)
        h = h + 0.01 * mm(jax.nn.silu(gate) * up, weights["down_w"])
    return h


def test_sweep_matches_the_jax_chain():
    """The tool's sweep through the plain versions at tiny() decoder widths
    in float32 against the chain of JAX's stacked kernels on the same
    codes: within 1e-5 relative. Every variant computes the same function
    of the same codes; W4A8 within its activation quantisation."""
    cfg = tiny()
    n_layers = cfg.decoder.n_layers
    weights = bench.make_weights(cfg, seed=0, device=torch.device("cpu"))
    wj = {name: {"packed": jnp.asarray(w["packed"].numpy()),
                 "scale": jnp.asarray(w["scale"].numpy())} for name, w in weights.items()}
    for name, w in weights.items():  # the int8 variant reads the same codes
        np.testing.assert_array_equal(t4.unpack_int4(w["packed"]).numpy(), w["q"].numpy())
        np.testing.assert_array_equal(bench.unpack_interleaved(w["interleaved"]).numpy(),
                                      w["q"].numpy())
    h0 = (np.random.default_rng(0).standard_normal((3, cfg.decoder.d_model)) * 0.1
          ).astype(np.float32)
    got = {v: bench.sweep(bench.VARIANTS[v], weights, torch.from_numpy(h0), n_layers)
           for v in bench.VARIANTS}
    for variant, mm_stacked in (("int4_w4a16", j4.int4_matmul_stacked),
                                ("int4_w4a8", j4.int4_matmul_w4a8_stacked)):
        want = np.asarray(_jax_sweep(mm_stacked, wj, jnp.asarray(h0), n_layers))
        err = np.abs(got[variant].numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-5, (variant, err)
    ref = got["int8"]
    for variant in ("int4_w4a16", "int4_packed", "bf16"):
        # bf16 weights: codes * a scale that bf16 holds exactly, rounded once
        tol = 1e-5 if variant != "bf16" else 4e-3
        torch.testing.assert_close(got[variant], ref, rtol=0, atol=tol * float(ref.abs().max()))
    assert float((got["int4_w4a8"] - ref).abs().max()) <= 0.02 * float(ref.abs().max())


def test_run_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run(batches=(1,), reps=1)


# ---------------------------------------------------------------- W4A8 designs

# nano's four decoder projections as (K/2, N): qkv, o, gate_up, down
NANO_K2_N = [(1024, 3072), (1024, 2048), (1024, 11008), (2752, 2048)]


def test_w4a8_uses_mma_from_5_rows():
    """The threshold measured on the H100: the tensor cores from 5 rows."""
    for B in range(1, 300):
        assert t4.w4a8_uses_mma(B) == (B >= t4.W4A8_MMA_MIN_ROWS)
    assert t4.W4A8_MMA_MIN_ROWS == 5
    assert not t4.w4a8_uses_mma(4) and t4.w4a8_uses_mma(5) and t4.w4a8_uses_mma(8)


@pytest.mark.parametrize("B", [5, 8, 9, 16, 37, 64, 227, 1536])
def test_w4a8_mma_shape_covers_every_row_and_column_once(B):
    """The mma design's grid (N/128 column tiles, B/64 row tiles, splits of
    K/2) covers every packed row and every output element exactly once,
    each split a whole number of stages that fits a block's shared memory,
    with about one block per SM."""
    for K2, N in NANO_K2_N:
        splits, kps = t4.w4a8_mma_shape(B, K2, N, 132)
        assert kps % t4.MMA_CHUNK_K == 0 and 0 < kps <= t4.MMA_MAX_K_PER_SPLIT
        rows = np.zeros(K2, int)
        for s in range(splits):
            rows[s * kps: min(K2, (s + 1) * kps)] += 1
        assert (rows == 1).all(), (K2, N, splits, kps)
        assert (splits - 1) * kps < K2  # no empty split
        cols = np.zeros((B, N), int)
        for bx in range(N // t4.MMA_TILE_N):
            for by in range(-(-B // t4.MMA_TILE_M)):
                cols[by * 64: (by + 1) * 64, bx * 128: (bx + 1) * 128] += 1
        assert (cols == 1).all()
        tiles = N // t4.MMA_TILE_N * -(-B // t4.MMA_TILE_M)
        fit = -(-K2 // t4.MMA_MAX_K_PER_SPLIT)  # splits for x to fit shared memory
        assert splits == 1 or tiles * splits <= max(132, tiles * fit) + tiles


def test_w4a8_mma_shape_at_the_sweep_shapes():
    """Pinned: at B=64, gate_up needs no split (86 tiles); qkv, o and down
    are split until about one block per SM; down at 227 rows splits only
    so that its quantised x fits shared memory."""
    got = [t4.w4a8_mma_shape(64, K2, N, 132) for K2, N in NANO_K2_N]
    assert got == [(4, 256), (8, 128), (1, 1024), (8, 384)]
    assert t4.w4a8_mma_shape(227, 2752, 2048, 132) == (2, 1408)


def test_w4a8_entries_launch_nothing_on_the_cpu():
    """On the CPU the W4A8 entries run the plain version: no kernel, no
    counter (the mma counter included)."""
    x, packed, scale = _inputs(5, 16, 256, 128, jnp.bfloat16)
    before = dict(_build.launch_counts)
    t4.int4_matmul_w4a8(_t(x), _t(packed), _t(scale))
    assert _build.launch_counts == before


def test_w4a8_quantisation_fast_path_rounds_as_the_division():
    """The kernels' quantisation (csrc/int4_matmul.cu `quant`), emulated in
    float32: x * rsx (rsx = 1 / sx rounded) stands in for the IEEE x / sx,
    and the division runs only within 2^-14 of a half; the integers equal
    those of rint(x / sx) everywhere, near-halves included."""
    rng = np.random.default_rng(0)
    for m in 10.0 ** rng.uniform(-6, 3, 25):
        m = np.float32(m)
        sx = np.float32(np.maximum(m, np.float32(1e-8)) / np.float32(127.0))
        rsx = np.float32(np.float32(1.0) / sx)
        halves = rng.integers(-127, 127, 50_000) + 0.5
        near = (halves * np.float64(sx) * (1 + rng.uniform(-1e-6, 1e-6, halves.size)))
        x = np.concatenate([(rng.uniform(-1, 1, 50_000) * m), near, [m, -m, 0.0]])
        x = x.astype(np.float32)
        exact = (x / sx).astype(np.float32)  # numpy's float32 division is IEEE
        q = (x * rsx).astype(np.float32)
        slow = np.abs(np.abs(q - np.rint(q)) - np.float32(0.5)) <= np.float32(2.0 ** -14)
        q = np.where(slow, exact, q)
        np.testing.assert_array_equal(np.clip(np.rint(q), -127, 127),
                                      np.clip(np.rint(exact), -127, 127))


# ---------------------------------------------------------------- W4A16 designs


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: byte n of the result is byte (s >> 4n) & 7 of
    the 8 bytes of y:x."""
    both = (y << 32) | x
    return sum(((both >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n) for n in range(4))


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _nibble_pairs_to_bf16(r: int) -> dict:
    """csrc/int4_matmul.cu nibble_pairs_to_bf16, emulated: one register of
    ldmatrix.trans (bytes p(k, c), p(k, c+1), p(k+1, c), p(k+1, c+1)) ->
    {(plane, column): [value at k, value at k+1]}; bf16 0x4300 | u is 128
    + u, and 136 comes off in bf16 (exact: checked against float64)."""
    lo = (r & 0x0F0F0F0F) ^ 0x08080808
    hi = ((r >> 4) & 0x0F0F0F0F) ^ 0x08080808
    out = {}
    for plane, w in (("lo", lo), ("hi", hi)):
        for col, sel in ((0, 0x4240), (1, 0x4341)):
            word = _byte_perm(w, 0x43434343, sel)
            halves = np.array([word & 0xFFFF, word >> 16], np.uint16)
            f = _bf16_bits_to_f32(halves).astype(np.float64) - 136.0
            diff = torch.from_numpy(f.astype(np.float32)).to(torch.bfloat16).float().numpy()
            assert (diff == f).all()  # __hsub2's bf16 result is exact
            out[plane, col] = diff
    return out


def test_nibble_to_bf16_is_exact_for_every_packed_byte():
    """The W4A16 mma design's nibble -> bf16 conversion, emulated bit for
    bit over all 256 packed byte values in each of the four byte positions
    of a register, both planes and both columns, against unpack_halves."""
    values = np.arange(256, dtype=np.uint8)
    lo, hi = (t.numpy().astype(np.float64) for t in
              t4.unpack_halves(torch.from_numpy(values.view(np.int8))))
    rng = np.random.default_rng(0)
    for pos in range(4):  # byte pos: (k, c), (k, c+1), (k+1, c), (k+1, c+1)
        for v in range(256):
            b = rng.integers(0, 256, 4)
            b[pos] = v
            got = _nibble_pairs_to_bf16(int(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24))
            for plane, ref in (("lo", lo), ("hi", hi)):
                assert list(got[plane, 0]) == [ref[b[0]], ref[b[2]]], (pos, v, plane)
                assert list(got[plane, 1]) == [ref[b[1]], ref[b[3]]], (pos, v, plane)


def test_w4a16_uses_mma_from_its_measured_threshold():
    """The threshold measured on the H100 (chip_smoke.py's A/B of both
    designs at nano's four decode projections, PERF.md): bf16 x from
    W4A16_MMA_MIN_ROWS rows; never float32 x, nor a shape the mma design
    does not take."""
    assert t4.W4A16_MMA_MIN_ROWS == 3
    for B in range(1, 300):
        assert t4.w4a16_uses_mma(B, torch.bfloat16) == (B >= t4.W4A16_MMA_MIN_ROWS)
        assert not t4.w4a16_uses_mma(B, torch.float32)
        assert not t4.w4a16_uses_mma(B, torch.bfloat16, aligned=False)


@pytest.mark.parametrize("B", [5, 8, 9, 16, 37, 64, 227, 1536])
def test_w4a16_mma_shape_covers_every_row_and_column_once(B):
    """The W4A16 mma design's grid covers every packed row and every output
    element exactly once, each split a whole number of stages, no split
    empty, and splits only while the tiles leave SMs idle."""
    for K2, N in NANO_K2_N + [(64, 256), (128, 128)]:
        splits, kps = t4.w4a16_mma_shape(B, K2, N, 132)
        assert kps % t4.MMA_CHUNK_K == 0 and kps > 0
        rows = np.zeros(K2, int)
        for s in range(splits):
            assert s * kps < K2  # no empty split
            rows[s * kps: min(K2, (s + 1) * kps)] += 1
        assert (rows == 1).all(), (K2, N, splits, kps)
        tiles = N // t4.MMA_TILE_N * -(-B // t4.MMA_TILE_M)
        assert splits == 1 or tiles * splits <= 132 + tiles
        cols = np.zeros((B, N), int)
        for bx in range(N // t4.MMA_TILE_N):
            for by in range(-(-B // t4.MMA_TILE_M)):
                cols[by * 64: (by + 1) * 64, bx * 128: (bx + 1) * 128] += 1
        assert (cols == 1).all()
    assert t4.w4a16_mma_shape(64, 1024, 11008, 132) == (1, 1024)  # gate_up: 86 tiles


def test_w4a16_entries_launch_nothing_on_the_cpu():
    """On the CPU the W4A16 entries run the plain version at any B: no
    kernel, no counter (the mma counter included)."""
    for B in (1, 16):
        x, packed, scale = _inputs(5, B, 256, 128, jnp.bfloat16, layers=2)
        before = dict(_build.launch_counts)
        t4.int4_matmul(_t(x), _t(packed[0]), _t(scale[0]))
        t4.int4_matmul_stacked(_t(x), _t(packed), _t(scale), 1)
        assert _build.launch_counts == before
