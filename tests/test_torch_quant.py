"""Port parity for the int8 serving modes: ops/quant.py and the plain
versions of the int8 kernels vs the JAX package on the CPU, and the
model, transcriber and runtime in each of int8, int8-decoder and
int8-decoder-a8 on tiny() f32 with the JAX-quantized tree carried over
bit-exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicscribe_tpu.engine.transcriber import Transcriber as TranscriberJax
from sonicscribe_tpu.models import glm_asr as jm
from sonicscribe_tpu.models import tiny as tiny_jax
from sonicscribe_tpu.models.tokenizer import ByteTokenizer as ByteTokenizerJax
from sonicscribe_tpu.ops import quant as jq
from sonicscribe_tpu.ops.int8_pallas import int8_matmul as int8_matmul_jax
from sonicscribe_tpu.ops.int8_pallas import int8_matmul_stacked as int8_matmul_stacked_jax
from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.engine.transcriber import Transcriber
from sonicscribe_tpu_torch.models import glm_asr as tm
from sonicscribe_tpu_torch.models import tiny
from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
from sonicscribe_tpu_torch.models.weights import load_checkpoint, params_from_jax
from sonicscribe_tpu_torch.ops import _build
from sonicscribe_tpu_torch.ops.int8_matmul import (
    CLUSTER_MAX,
    MAX_SMEM,
    cluster_shape,
    cluster_smem,
    div127,
    int8_matmul,
    int8_matmul_stacked,
    int8_matmul_w8a8,
    launch_shape,
    quantize_activations,
    uses_mma,
)
from sonicscribe_tpu_torch.ops.quant import (
    is_qtensor,
    matmul_w8a8,
    quantize_params_int8,
    quantize_tensor,
)
from sonicscribe_tpu_torch.serve.runtime import build_runtime

MODES = ("int8", "int8-decoder", "int8-decoder-a8")
TOL = dict(rtol=2e-4, atol=2e-4)  # float32, different summation orders
BUCKETS = (128, 256)


def _t(a) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor with the same bits."""
    return params_from_jax(np.asarray(a), device="cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_within_bf16_ulp(got, want):
    """|got - want| <= one bf16 ulp of want: the float32 sums differ only
    in order, then one rounding to bf16."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126))) - 7)
    excess = np.abs(got - want) - ulp
    assert excess.max() <= 0, f"off by more than one bf16 ulp: {np.abs(got - want).max()}"


def _mode_cfgs(mode):
    cfg_j, cfg = tiny_jax(), tiny()
    if mode == "int8-decoder-a8":
        cfg_j = dataclasses.replace(
            cfg_j, decoder=dataclasses.replace(cfg_j.decoder, act_int8_decode=True))
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, act_int8_decode=True))
    return cfg_j, cfg


@pytest.fixture(scope="module")
def base_params():
    # scaled so greedy tokens vary (at init scale it repeats one token)
    return jax.tree.map(
        lambda x: x * 4.0, jm.init_params(tiny_jax(), jax.random.PRNGKey(7), dtype=jnp.float32)
    )


def _quantized(params_j, mode):
    """-> (JAX-quantized tree, the same tree carried over to the port)."""
    qj = jq.quantize_params_int8(params_j, decoder_only=mode != "int8")
    return qj, params_from_jax(jax.tree.map(np.asarray, qj), device="cpu")


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("shape,dtype", [
    ((64, 48), jnp.float32), ((3, 128, 96), jnp.float32), ((2, 384, 256), jnp.bfloat16),
])
def test_quantize_tensor_bit_exact(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    w = jnp.asarray(rng.standard_normal(shape) * 0.05, dtype)
    w = w.at[..., 0].set(0.0)  # an all-zero column: the 1e-8 scale floor
    want = jq.quantize_tensor(w)
    got = quantize_tensor(_t(w))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    assert tuple(got["scale"].shape) == shape[:-2] + (1, shape[-1])
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))


@pytest.mark.parametrize("decoder_only", [False, True])
def test_quantize_params_int8_same_tree(decoder_only):
    params_j = jm.init_params(tiny_jax(), jax.random.PRNGKey(0), dtype=jnp.float32)
    want = dict(_leaves(jax.tree.map(np.asarray, jq.quantize_params_int8(params_j, decoder_only))))
    got = dict(_leaves(quantize_params_int8(
        params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu"), decoder_only)))
    assert got.keys() == want.keys()
    assert ("/encoder/layers/o_w/q" in got) is not decoder_only  # the encoder's o_w too
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)


@pytest.mark.parametrize("b,k,n", [(1, 256, 384), (5, 128, 512), (16, 384, 128), (64, 256, 256)])
def test_int8_matmul_plain_matches_pallas(b, k, n):
    rng = np.random.default_rng(b)
    x = jnp.asarray(rng.standard_normal((b, k)), jnp.bfloat16) * 0.1
    qt = jq.quantize_tensor(jnp.asarray(rng.standard_normal((k, n)), jnp.float32) * 0.02)
    want = int8_matmul_jax(x, qt["q"], qt["scale"], interpret=True)
    before = dict(_build.launch_counts)
    got = int8_matmul(_t(x), _t(qt["q"]), _t(qt["scale"]))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, n)
    assert _build.launch_counts == before  # the CPU runs the plain version
    _assert_within_bf16_ulp(_np(got), want)


def test_int8_matmul_stacked_plain_matches_pallas():
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((4, 256)), jnp.bfloat16) * 0.1
    qt = jq.quantize_tensor(jnp.asarray(rng.standard_normal((3, 256, 384)), jnp.float32) * 0.02)
    for layer in range(3):
        want = int8_matmul_stacked_jax(x, qt["q"], qt["scale"], layer, interpret=True)
        got = int8_matmul_stacked(_t(x), _t(qt["q"]), _t(qt["scale"]), layer)
        _assert_within_bf16_ulp(_np(got), want)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_w8a8_plain_matches_jax(dtype):
    """Equal outputs: the activation quantisation is the same float32
    arithmetic and the integer sums are exact on both sides."""
    rng = np.random.default_rng(4)
    qt = jq.quantize_tensor(jnp.asarray(rng.standard_normal((3, 256, 96)), jnp.float32) * 0.02)
    for shape in ((3, 256), (2, 3, 256)):
        x = jnp.asarray(rng.standard_normal(shape), dtype)
        for layer in range(3):
            want = jq.matmul_w8a8(x, {"q": qt["q"][layer], "scale": qt["scale"][layer]})
            stacked = {"q": _t(qt["q"]), "scale": _t(qt["scale"]), "layer": layer}
            got = matmul_w8a8(_t(x), stacked)
            assert got.dtype == _t(x).dtype and tuple(got.shape) == shape[:-1] + (96,)
            np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
        flat = matmul_w8a8(_t(x), {"q": _t(qt["q"][1]), "scale": _t(qt["scale"][1])})
        np.testing.assert_array_equal(_np(flat), _np(int8_matmul_w8a8(
            _t(x).reshape(-1, 256), _t(qt["q"]), _t(qt["scale"]), 1)).reshape(flat.shape))
    w = torch.from_numpy(rng.standard_normal((256, 8)).astype(np.float32))
    x = torch.ones((2, 256))
    torch.testing.assert_close(matmul_w8a8(x, w), x @ w, rtol=0, atol=0)  # plain passes through


def test_launch_shape_covers_k_and_fills_the_card():
    nano = [(2048, 3072), (2048, 2048), (2048, 11008), (5504, 2048)]
    for B in (1, 4, 8):
        for K, N in nano:
            rows, splits, kps = launch_shape(B, K, N, 132)
            assert rows == {1: 1, 4: 4, 8: 8}[B] and kps % 128 == 0
            assert splits * kps >= K > (splits - 1) * kps
            blocks = -(-N // 128) * splits
            assert blocks >= 132 or splits * 128 >= K, (B, K, N, splits)
    assert launch_shape(419, 2048, 3072, 132)[1:] == (1, 2048)  # prefill: no split
    assert launch_shape(1536, 1024, 4096, 132)[1] == 1  # encoder fc1


# int4's launch_shape(B, K/2, N, 132) at nano's qkv, o, gate_up and down, as
# ops/int4_matmul.py has had them since the int4 kernels were added
INT4_LAUNCH_SHAPES = {
    1: [(1, 8, 128), (1, 8, 128), (1, 4, 256), (1, 22, 128)],
    2: [(2, 8, 128), (2, 8, 128), (2, 4, 256), (2, 22, 128)],
    4: [(4, 8, 128), (4, 8, 128), (4, 4, 256), (4, 22, 128)],
    8: [(8, 8, 128), (8, 8, 128), (8, 4, 256), (8, 22, 128)],
    16: [(8, 8, 128), (8, 8, 128), (8, 4, 256), (8, 11, 256)],
    37: [(8, 4, 256), (8, 4, 256), (8, 2, 512), (8, 6, 512)],
    64: [(8, 3, 384), (8, 4, 256), (8, 1, 1024), (8, 5, 640)],
}


@pytest.mark.parametrize("B", sorted(INT4_LAUNCH_SHAPES))
def test_launch_shape_unchanged_for_int4(B):
    nano = [(2048, 3072), (2048, 2048), (2048, 11008), (5504, 2048)]
    got = [launch_shape(B, K // 2, N, 132) for K, N in nano]
    assert got == INT4_LAUNCH_SHAPES[B]


# (K, N) of the products that reach the cluster split-K design: nano's and
# tiny's decoder projections (for int4, K is the packed rows K/2), and the
# encoders' flat projections (float32 x at any B)
NANO_DEC = [(2048, 3072), (2048, 2048), (2048, 11008), (5504, 2048)]
TINY_DEC = [(128, 256), (128, 128), (128, 512), (256, 128)]
ENCODERS = [(1024, 1024), (1024, 4096), (4096, 1024), (64, 64), (64, 256), (256, 64)]


def _cluster_cases():
    for K, N in NANO_DEC + TINY_DEC:
        yield 1, K, N
        yield 2, K // 2, N
    for K, N in ENCODERS:
        yield 1, K, N


@pytest.mark.parametrize("halves,K,N", list(_cluster_cases()))
def test_cluster_shape_covers_every_row_and_column_once(halves, K, N):
    """The one-launch design's grid (column tiles x row tiles x a cluster
    of CTAs along K) covers every row of q and every output element exactly
    once, no CTA without rows, a power-of-two cluster of at most 16, each
    CTA's shared memory within the card's, at decode rows and beyond."""
    for B in (1, 2, 3, 4, 5, 8, 9, 37, 419):
        s = cluster_shape(B, K, N, halves)
        assert s.rows == {1: 1, 2: 2, 3: 4, 4: 4}.get(B, 8), (B, s)
        assert s.cluster in (1, 2, 4, 8, 16) and s.cluster <= CLUSTER_MAX
        assert s.k_per_cta % 16 == 0 and cluster_smem(halves, s.rows, s.cluster,
                                                      s.k_per_cta) <= MAX_SMEM
        assert s.grid == (-(-N // 128), -(-B // s.rows), s.cluster)
        rows = np.zeros(K, int)
        for rank in range(s.cluster):
            lo, hi = rank * s.k_per_cta, min(K, (rank + 1) * s.k_per_cta)
            assert hi > lo, (B, K, N, s)  # no empty CTA
            rows[lo:hi] += 1
        assert (rows == 1).all(), (B, K, N, s)
        cols = np.zeros((B, N), int)
        for bx in range(s.grid[0]):
            for by in range(s.grid[1]):
                cols[by * s.rows: (by + 1) * s.rows, bx * 128: (bx + 1) * 128] += 1
        assert (cols == 1).all()


def test_cluster_shape_at_nano_decode_rows():
    """Pinned, the H100 sweep's choices (PERF.md): slices of at most 256
    rows of q per CTA up to 4 x rows and 512 at 8, in clusters of at most 16
    (down's K = 5504 needs 16 CTAs of 352 rows); int4's packed rows hold
    two rows of the weight each, so its slices hold half as many."""
    got = [[cluster_shape(B, K, N)[1:3] for K, N in NANO_DEC] for B in (1, 2, 4, 8)]
    assert got == [[(8, 256), (8, 256), (8, 256), (16, 352)]] * 3 + [
        [(4, 512), (4, 512), (4, 512), (16, 352)]]
    got = [cluster_shape(1, K // 2, N, halves=2)[1:3] for K, N in NANO_DEC]
    assert got == [(8, 128), (8, 128), (8, 128), (16, 176)]


def test_div127_is_the_ieee_division_on_the_cpu():
    """div127 and the quantisers built on it give JAX's bits (its float32
    division by 127) where a multiply by the rounded reciprocal, PyTorch's
    CUDA form of `/ 127.0`, does not: on values chosen where the two
    differ, and on random rows' scales."""
    rng = np.random.default_rng(11)
    v = rng.uniform(1e-3, 10.0, 200_000).astype(np.float32)
    want = np.asarray(jnp.asarray(v) / jnp.float32(127.0))
    recip = v * (np.float32(1.0) / np.float32(127.0))
    differ = recip != want
    assert differ.mean() > 0.01  # the reciprocal form would fail this test
    np.testing.assert_array_equal(div127(torch.from_numpy(v)).numpy(), want)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    x[0] = 0.0  # the 1e-8 floor
    x[1, 3] = v[np.argmax(differ)]  # a row whose scale needs the division
    x[1] = np.clip(x[1], -x[1, 3], x[1, 3])
    _, sx = quantize_activations(torch.from_numpy(x))
    want_sx = np.asarray(jnp.maximum(jnp.abs(jnp.asarray(x)).max(axis=-1, keepdims=True),
                                     jnp.float32(1e-8)) / jnp.float32(127.0))
    np.testing.assert_array_equal(sx.numpy(), want_sx)
    w = rng.standard_normal((256, 64)).astype(np.float32)
    w[:, 5] = np.clip(w[:, 5], -v[np.argmax(differ)], v[np.argmax(differ)])
    np.testing.assert_array_equal(quantize_tensor(torch.from_numpy(w))["scale"].numpy(),
                                  np.asarray(jq.quantize_tensor(jnp.asarray(w))["scale"]))


def test_library_path_hashes_the_included_headers(tmp_path, monkeypatch):
    """An edited header of csrc/, included directly or through another
    header, changes the library's digest, so a stale library is never
    loaded; a header the source does not include does not."""
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\nint f();\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// other\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = _build.library_path("k")
    (tmp_path / "other.cuh").write_text("// other, edited\n")
    assert _build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = _build.library_path("k")
    assert second != first and second.name.startswith("k-")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// edited\n')
    assert _build.library_path("k") not in (first, second)


def test_every_kernel_source_and_header_is_hashed():
    """The package's own sources: each kernel's digest covers the headers
    it includes (act_quant.cuh, cluster_splitk.cuh, common.cuh, s8_mma.cuh)."""
    for name in _build.KERNELS:
        assert _build.sources(name)[0].name == f"{name}.cu"
    for name in ("int8_matmul", "int4_matmul"):
        assert {p.name for p in _build.sources(name)[1:]} == {
            "act_quant.cuh", "cluster_splitk.cuh", "common.cuh", "s8_mma.cuh"}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_flat_dispatch_picks_mma_exactly_for_bf16_above_8_rows(dtype):
    """The tensor-core design for bf16 x with B > 8 at every K of nano's
    flat projections; the CUDA-core one for decode rows and float32 x."""
    for K in (1024, 2048, 4096, 5504):
        for B in (1, 2, 4, 8, 9, 16, 17, 227, 419, 1024, 1536):
            assert uses_mma(B, K, dtype) == (dtype == torch.bfloat16 and B > 8), (B, K)
    assert not uses_mma(419, 2048, dtype, aligned=False)  # 16-byte copies and loads
    assert not uses_mma(419, 2052, dtype)  # x rows not 16-byte aligned


# ---------------------------------------------------------------- model


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_logits(base_params, mode):
    cfg_j, cfg = _mode_cfgs(mode)
    qj, qt = _quantized(base_params, mode)
    rng = np.random.default_rng(1)
    embeds = (rng.standard_normal((2, 10, cfg.decoder.d_model)) * 0.5).astype(np.float32)
    length = np.asarray([10, 7], np.int32)
    cache_j = jm.init_cache(cfg_j, 2, 16, dtype=jnp.float32)
    cache_j, want = jm.prefill(qj, cfg_j, jnp.asarray(embeds), jnp.asarray(length), cache_j)
    cache = tm.init_cache(cfg, 2, 16, dtype=torch.float32)
    cache, got = tm.prefill(qt, cfg, torch.from_numpy(embeds), torch.from_numpy(length), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for step in range(4):
        tokens = rng.integers(0, cfg.decoder.vocab_size, size=2).astype(np.int32)
        cache_j, want = jm.decode_step(qj, cfg_j, cache_j, jnp.asarray(tokens))
        cache, got = tm.decode_step(qt, cfg, cache, torch.from_numpy(tokens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"step {step}", **TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(cache_j["k"]), **TOL)

    mel = (rng.standard_normal((1, 128, 128)) * 0.5).astype(np.float32)
    n = np.asarray([100], np.int32)
    want, _ = jm.encode_audio(qj, cfg_j, jnp.asarray(mel), jnp.asarray(n))
    got, _ = tm.encode_audio(qt, cfg, torch.from_numpy(mel), torch.from_numpy(n))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _audio(seconds, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.3 * np.sin(2 * np.pi * 300 * t) * (1 + np.sin(2 * np.pi * 2 * t))
    return (x + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
def test_transcriber_tokens_exact(base_params, mode):
    cfg_j, cfg = _mode_cfgs(mode)
    qj, qt = _quantized(base_params, mode)
    jax_tr = TranscriberJax(cfg_j, qj, ByteTokenizerJax(cfg_j), prefill_buckets=BUCKETS)
    port_tr = Transcriber(cfg, qt, ByteTokenizer(cfg), prefill_buckets=BUCKETS)
    audio = _audio(1.2, 16000, seed=12)
    want = jax_tr.transcribe(audio, 16000, max_new_tokens=16)
    got = port_tr.transcribe(audio, 16000, max_new_tokens=16)
    assert len(set(want.tokens.tolist())) > 3
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.text == want.text


# ---------------------------------------------------------------- loading, runtime


@pytest.mark.parametrize("decoder_only", [False, True])
def test_int8_checkpoint_round_trip(tmp_path, decoder_only):
    """A quantized bf16 tree written by the JAX package's save_checkpoint
    loads as QTensor dicts, every leaf bit-exact."""
    from sonicscribe_tpu.tools.convert_weights import save_checkpoint

    cfg_j = tiny_jax()
    qj = jq.quantize_params_int8(
        jm.init_params(cfg_j, jax.random.PRNGKey(5), dtype=jnp.bfloat16), decoder_only)
    save_checkpoint(qj, cfg_j, str(tmp_path))
    _, params, _ = load_checkpoint(str(tmp_path), device="cpu")
    assert is_qtensor(params["decoder"]["layers"]["gate_up_w"])
    assert is_qtensor(params["encoder"]["layers"]["fc1_w"]) is not decoder_only
    got = dict(_leaves(params))
    want = dict(_leaves(jax.tree.map(np.asarray, qj)))
    assert got.keys() == want.keys()
    for name, w in want.items():
        t = got[name]
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          w.view(np.uint16), err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), w, err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_build_runtime_int8_modes_on_cpu(mode):
    config = AppConfig()
    config.quant_mode = mode
    engine, _, info = build_runtime("tiny-random", "energy", config, device="cpu",
                                    engine_kind="threaded")
    try:
        tr = engine.transcriber
        layers = tr.params["decoder"]["layers"]
        assert info["quant_mode"] == mode
        assert all(is_qtensor(layers[k]) for k in ("qkv_w", "o_w", "gate_up_w", "down_w"))
        assert not is_qtensor(tr.params["decoder"]["embed"])
        assert not is_qtensor(tr.params["adapter"]["fc1"]["w"])
        assert is_qtensor(tr.params["encoder"]["layers"]["o_w"]) == (mode == "int8")
        assert tr.cfg.decoder.act_int8_decode == (mode == "int8-decoder-a8")
        r = tr.transcribe(_audio(0.5, 16000, seed=1), 16000, max_new_tokens=4)
        assert isinstance(r.text, str) and len(r.tokens) > 0
    finally:
        engine.shutdown()


def test_bench_sweep_chains_the_variants_on_cpu():
    """The bench tool's sweep through the plain versions at tiny width:
    the int8 variants track bf16 within quantization error. Timing needs
    the card: run() raises without one."""
    from sonicscribe_tpu_torch.tools import bench_int8_matmul as bench

    cfg = tiny()
    w = bench.layer_weights(cfg, seed=0, device=torch.device("cpu"))
    w = {k: v.float() for k, v in w.items()}
    wq = {k: quantize_tensor(v) for k, v in w.items()}
    h0 = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 128)).astype(np.float32))
    ref = bench.sweep(bench.VARIANTS["bf16"], w, h0, cfg.decoder.n_layers)
    for variant in ("int8", "int8_w8a8"):
        got = bench.sweep(bench.VARIANTS[variant], wq, h0, cfg.decoder.n_layers)
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) < 0.02 * float(ref.abs().max())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.run()
