"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a card every test skips. The file imports neither
JAX nor the JAX package, so it also runs where JAX is absent. Its eager
oracle of the transcriber is chip_smoke.py's, imported from the repo root,
from which it runs:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from sonicscribe_tpu_torch.audio.mel import (
    MelConfig,
    device_tables,
    normalize_log_mel,
    reflect_pad,
)
from sonicscribe_tpu_torch.device import resolve_device
from chip_smoke import TINY_STREAM_SPANS, drive_stepped, eager_transcriber, stream_frames
from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.engine import transcriber as transcriber_module
from sonicscribe_tpu_torch.engine.transcriber import BUDGET_CEILINGS, Transcriber
from sonicscribe_tpu_torch.models import glm_asr as tm
from sonicscribe_tpu_torch.models.config import tiny
from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
from sonicscribe_tpu_torch.models.weights import init_random
from sonicscribe_tpu_torch.ops import _build
from sonicscribe_tpu_torch.ops import mel as tmel
from sonicscribe_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
    split_shape,
    verify_attention,
    verify_attention_plain,
)
from sonicscribe_tpu_torch.ops.int4_matmul import (
    int4_matmul,
    int4_matmul_plain,
    int4_matmul_stacked,
    int4_matmul_stacked_plain,
    int4_matmul_w4a8,
    int4_matmul_w4a8_plain,
    int4_matmul_w4a8_stacked,
    int4_matmul_w4a8_stacked_plain,
    pack_int4,
    w4a8_uses_mma,
    w4a16_uses_mma,
)
from sonicscribe_tpu_torch.ops import int8_matmul as im
from sonicscribe_tpu_torch.ops.int8_matmul import (
    W8A8_MMA_MIN_ROWS,
    div127,
    int8_matmul,
    int8_matmul_plain,
    int8_matmul_stacked,
    int8_matmul_stacked_plain,
    int8_matmul_w8a8,
    int8_matmul_w8a8_plain,
)
from sonicscribe_tpu_torch.ops.mel import (
    FRAMES_PER_BLOCK,
    log_mel_frames,
    log_mel_frames_plain,
)
from sonicscribe_tpu_torch.ops.quant import quantize_tensor

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    # full float32: the plain mel's conv1d would otherwise run in cuDNN's TF32
    return resolve_device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [200, 803])
def test_decode_attention_kernel(cuda, dtype, M):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((3, 16, 128), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, 3, M, 4, 128), generator=g, device=cuda).to(dtype)[1]
    v = torch.randn((2, 3, M, 4, 128), generator=g, device=cuda).to(dtype)[1]
    lens = torch.tensor([0, M // 2, M], dtype=torch.int32, device=cuda)
    before = _build.launch_counts["decode_attention"]
    got = decode_attention(q, k, v, lens)
    assert _build.launch_counts["decode_attention"] == before + 1
    want = decode_attention_plain(q, k, v, lens)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)  # float32 sums, other order


def _attention_inputs(device, dtype, S, M, seed=0):
    """q and one layer of a [2, S, M, 4, 128] cache (the strided view the
    decode step passes), nano's heads."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((S, 16, 128), generator=g, device=device).to(dtype)
    k = torch.randn((2, S, M, 4, 128), generator=g, device=device).to(dtype)[1]
    v = torch.randn((2, S, M, 4, 128), generator=g, device=device).to(dtype)[1]
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,M", [(1, 675), (4, 1024)])
def test_decode_attention_split_boundaries(cuda, dtype, S, M):
    """lens on either side of a split boundary (slot sees lens + 1
    positions), lens >= M, and mixed lens in one batch."""
    q, k, v = _attention_inputs(cuda, dtype, S, M, seed=S)
    chunk, _ = split_shape(S, M, 4, _build.n_sms(cuda))
    cases = [[L] * S for L in (chunk - 2, chunk - 1, chunk, 2 * chunk - 1, M - 1, M, M + 5)]
    if S == 4:
        cases.append([0, chunk - 1, chunk, M])
    for lens_list in cases:
        lens = torch.tensor(lens_list, dtype=torch.int32, device=cuda)
        got = decode_attention(q, k, v, lens)
        want = decode_attention_plain(q, k, v, lens)
        # float32 sums in another order
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5, msg=f"lens {lens_list}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_is_deterministic(cuda, dtype):
    """The splits are merged in a fixed order, with no float atomics."""
    q, k, v = _attention_inputs(cuda, dtype, 4, 1024, seed=9)
    lens = torch.tensor([5, 300, 677, 1023], dtype=torch.int32, device=cuda)
    assert torch.equal(decode_attention(q, k, v, lens), decode_attention(q, k, v, lens))


def _verify_lens(S, M, g, device):
    """The chip phase's lens: 674 at S 1; mixed at S 4; at S 33 mixed with
    some slots past M - W1 (their writes past the end), one at M."""
    if S == 1:
        return torch.tensor([674], dtype=torch.int32, device=device)
    if S == 4:
        return torch.tensor([0, 300, 795, M - 1], dtype=torch.int32, device=device)
    lens = torch.randint(0, M, (S,), generator=g, device=device)
    lens[:6] = torch.tensor([0, M - 1, M - 3, M - 9, M - 5, M])
    return lens.to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 4, 33])
@pytest.mark.parametrize("W1", [9, 1])
def test_verify_attention_kernel(cuda, dtype, S, W1):
    """The verify kernel at nano's heads and the long pool's M = 803
    against its plain version (float32 sums in another order); at W1 = 1
    it is the decode kernel, bit for bit."""
    M = 803
    g = torch.Generator(device=cuda).manual_seed(S * 10 + W1)
    _, k, v = _attention_inputs(cuda, dtype, S, M, seed=S + W1)
    q = torch.randn((S, W1, 16, 128), generator=g, device=cuda).to(dtype)
    lens = _verify_lens(S, M, g, cuda)
    before = dict(_build.launch_counts)
    got = verify_attention(q, k, v, lens)
    assert _build.launch_counts["verify_attention"] == before["verify_attention"] + 1
    assert _build.launch_counts["decode_attention"] == before["decode_attention"]
    torch.testing.assert_close(got, verify_attention_plain(q, k, v, lens), rtol=0, atol=2e-5)
    if W1 == 1:
        assert torch.equal(got[:, 0], decode_attention(q[:, 0], k, v, lens))


def _speech(sec, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * sec)) / 16000
    env = 0.5 * (1 + np.sin(2 * np.pi * 3 * t))
    x = 0.25 * env * sum(np.sin(2 * np.pi * f * t) for f in (200, 700, 1500, 2600))
    return (x + 0.002 * rng.standard_normal(len(t))).astype(np.float32)


def test_log_mel_kernel(cuda):
    cfg = MelConfig()
    rng = np.random.default_rng(0)
    x = torch.from_numpy((0.1 * rng.standard_normal(16000 * 3 + 77)).astype(np.float32))
    padded, nf = reflect_pad(x.to(cuda), cfg)
    basis, fb = device_tables(cfg, cuda)
    before = _build.launch_counts["log_mel"]
    got = log_mel_frames(padded, basis, fb, nf, cfg.hop_length)
    assert _build.launch_counts["log_mel"] == before + 1
    want = log_mel_frames_plain(padded, basis, fb, nf, cfg.hop_length)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)  # float32 DFT sums


def _plain_f64(padded, basis, fb, n_frames, hop):
    """The plain version on the same inputs in float64: the exact function
    to within float64's rounding."""
    return log_mel_frames_plain(padded.double(), basis.double(), fb.double(), n_frames,
                                hop).float()


def _assert_every_tile_close(padded, basis, fb, n_frames, hop, want):
    """The kernel through the entry (its own tile choice, one count) and in
    each frame tile, within 1e-4 raw log10 of `want` over every element."""
    before = _build.launch_counts["log_mel"]
    torch.testing.assert_close(log_mel_frames(padded, basis, fb, n_frames, hop), want, rtol=0,
                               atol=1e-4)
    assert _build.launch_counts["log_mel"] == before + 1
    for tile in FRAMES_PER_BLOCK:
        got, err = tmel._launch(padded, basis, fb, n_frames, hop, tile)
        assert err == 0, (tile, err)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_frames", [1, 15, 16, 17, 1200, 3072])
def test_log_mel_kernel_frame_counts(cuda, n_frames):
    """Noise at frame counts on either side of a tile: within 1e-4 raw
    log10 of the plain version in float64. The float32 plain version is no
    yardstick at that tolerance here: in the deepest dip of the 16-frame
    case (frame 0, 7 decades down) it is itself further than that from
    float64."""
    cfg = MelConfig()
    rng = np.random.default_rng(n_frames)
    n = n_frames * cfg.hop_length + int(rng.integers(0, cfg.hop_length))
    x = torch.from_numpy((0.1 * rng.standard_normal(n)).astype(np.float32))
    padded, nf = reflect_pad(x.to(cuda), cfg)
    assert nf == n_frames
    basis, fb = device_tables(cfg, cuda)
    _assert_every_tile_close(padded, basis, fb, nf, cfg.hop_length,
                             _plain_f64(padded, basis, fb, nf, cfg.hop_length))


def test_log_mel_kernel_quiet_then_loud(cuda):
    """6 s of near silence (noise of std 6e-4), then 6 s of loud noise
    (std 0.1): within 1e-4 raw log10 of the plain version, in float32 and
    in float64, over every element; the quiet frames' error scales with
    their own level, not the loud frames'."""
    cfg = MelConfig()
    quiet = 0.0006 * np.random.default_rng(7).standard_normal(16000 * 6)
    loud = 0.1 * np.random.default_rng(9).standard_normal(16000 * 6)
    x = torch.from_numpy(np.concatenate([quiet, loud]).astype(np.float32))
    padded, nf = reflect_pad(x.to(cuda), cfg)
    basis, fb = device_tables(cfg, cuda)
    want = log_mel_frames_plain(padded, basis, fb, nf, cfg.hop_length)
    torch.testing.assert_close(log_mel_frames(padded, basis, fb, nf, cfg.hop_length), want,
                               rtol=0, atol=1e-4)
    _assert_every_tile_close(padded, basis, fb, nf, cfg.hop_length,
                             _plain_f64(padded, basis, fb, nf, cfg.hop_length))


@pytest.mark.parametrize("n_mels", [32, 64])
def test_log_mel_kernel_wide_filters(cuda, n_mels):
    """Filter banks whose filters span more bins (34 and 18) than the 16
    the kernel holds in registers: the rest of each band is read from the
    cache, within 1e-4 raw log10 of the plain version in float64."""
    cfg = MelConfig(n_mels=n_mels)
    x = torch.from_numpy((0.1 * np.random.default_rng(n_mels).standard_normal(16000 * 4))
                         .astype(np.float32))
    padded, nf = reflect_pad(x.to(cuda), cfg)
    basis, fb = device_tables(cfg, cuda)
    _assert_every_tile_close(padded, basis, fb, nf, cfg.hop_length,
                             _plain_f64(padded, basis, fb, nf, cfg.hop_length))


@pytest.mark.parametrize("signal", ["speech", "quiet_then_loud"])
def test_log_mel_kernel_on_tonal_signals(cuda, signal):
    """Partials leave valleys up to 10 decades deep between them, where
    float32 itself (the plain version) is ~1e-3 off float64 in log10 on
    the card (chip_smoke prints both): within 1e-3 raw log10 where the
    normalisation keeps the value (max - 8 and up), and within 1e-3
    normalised everywhere (chip_smoke's MEL_TOL)."""
    cfg = MelConfig()
    x = _speech(12.0, 2)
    if signal == "quiet_then_loud":
        quiet = 0.0006 * np.random.default_rng(7).standard_normal(16000 * 6)
        x = np.concatenate([quiet.astype(np.float32), _speech(6.0, 7)])
    padded, nf = reflect_pad(torch.from_numpy(x).to(cuda), cfg)
    basis, fb = device_tables(cfg, cuda)
    got = log_mel_frames(padded, basis, fb, nf, cfg.hop_length)
    want = log_mel_frames_plain(padded, basis, fb, nf, cfg.hop_length)
    kept = want >= want.max() - cfg.dynamic_range_db_factor
    assert float((got - want).abs()[kept].max()) <= 1e-3
    torch.testing.assert_close(normalize_log_mel(got, cfg), normalize_log_mel(want, cfg),
                               rtol=0, atol=1e-3)


def test_greedy_generate_card_matches_cpu(cuda):
    cfg = tiny()
    params = init_random(cfg, seed=3, dtype=torch.float32, device="cpu")

    def scaled(tree, device):  # x4 so the random model's tokens vary
        if isinstance(tree, dict):
            return {k: scaled(v, device) for k, v in tree.items()}
        return (tree * 4.0).to(device)

    on_card, on_cpu = scaled(params, cuda), scaled(params, "cpu")
    rng = np.random.default_rng(1)
    embeds = torch.from_numpy((0.5 * rng.standard_normal((2, 12, 128))).astype(np.float32))
    length = torch.tensor([12, 9], dtype=torch.int32)
    want, _ = tm.greedy_generate(on_cpu, cfg, embeds, length, 16)
    got, _ = tm.greedy_generate(on_card, cfg, embeds.to(cuda), length.to(cuda), 16)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def _tiny_transcribers(device, seed=3):
    """(captured on `device`, chip_smoke.py's eager oracle on `device`) over
    one tiny() f32 tree x4."""
    cfg = tiny()
    params = init_random(cfg, seed=seed, dtype=torch.float32, device="cpu")

    def scaled(tree):
        if isinstance(tree, dict):
            return {k: scaled(v) for k, v in tree.items()}
        return (tree * 4.0).to(device)

    captured = Transcriber(cfg, scaled(params), ByteTokenizer(cfg), prefill_buckets=(128, 256))
    return captured, eager_transcriber(captured)


@pytest.mark.parametrize("k", [1, 8])
def test_captured_tokens_equal_greedy_generate(cuda, k, monkeypatch):
    """The transcriber's graphs replayed on the card give greedy_generate's
    tokens on the card (budget 21, not a multiple of k, on ceiling 200's
    graph), and the replays count the decode attention launches of every
    step they ran."""
    captured, eager = _tiny_transcribers(cuda)
    monkeypatch.setattr(transcriber_module, "DECODE_STEPS", k)
    for sec, hotwords in ((1.0, None), (2.2, ["hi"])):
        audio = _speech(sec, seed=20)
        want = eager.transcribe(audio, 16000, max_new_tokens=21, hotwords=hotwords)
        steps0 = captured.stats["decode_steps"]
        _build.reset_launch_counts()
        got = captured.transcribe(audio, 16000, max_new_tokens=21, hotwords=hotwords)
        steps = captured.stats["decode_steps"] - steps0
        assert len(want.tokens) > 0
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert _build.launch_counts["decode_attention"] == tiny().decoder.n_layers * steps
    keys = set(captured.router.entries)
    assert ("prompt", 128, 3) in keys and ("decode", 256, 200, k, 3) in keys
    assert not any(key[0] == "decode" and key[2] != 200 for key in keys)  # no tail graph


def test_capture_holds_while_another_thread_resamples(cuda):
    """/transcribe/file resamples uploads on the card in another thread
    while the engine thread may capture: the graphs captured meanwhile give
    the tokens of graphs captured alone."""
    import threading

    from sonicscribe_tpu_torch.audio.resample import resample

    alone, _ = _tiny_transcribers(cuda)
    busy, _ = _tiny_transcribers(cuda)
    audio = _speech(2.2, seed=21)
    want = alone.transcribe(audio, 16000, max_new_tokens=24).tokens
    stop, errors, runs = threading.Event(), [], [0]
    upload = torch.from_numpy(_speech(3.0, seed=22))

    def resampling():
        try:
            while not stop.is_set():
                resample(upload.to(cuda), 44100, 16000).cpu()
                runs[0] += 1
        except Exception as e:  # reported by the main thread
            errors.append(e)

    thread = threading.Thread(target=resampling)
    thread.start()
    try:
        busy.warmup(budgets=(24,))
        got = busy.transcribe(audio, 16000, max_new_tokens=24).tokens
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive() and not errors and runs[0] > 0
    assert busy.router.stats["graphs"] == 2 * 2  # per bucket: prompt, ceiling 200's decode
    np.testing.assert_array_equal(got, want)


def test_a_final_at_an_unwarmed_budget_captures_no_graph(cuda):
    """With the app's grid warmed, finals at budgets that were never warmed
    run on their ceiling's graphs: no capture, greedy_generate's tokens."""
    captured, eager = _tiny_transcribers(cuda)
    captured.warmup(budgets=BUDGET_CEILINGS)
    graphs = captured.router.stats["graphs"]
    assert graphs == 2 * (1 + len(BUDGET_CEILINGS))
    for budget in (57, 113):
        audio = _speech(1.7, seed=23)
        want = eager.transcribe(audio, 16000, max_new_tokens=budget)
        got = captured.transcribe(audio, 16000, max_new_tokens=budget)
        np.testing.assert_array_equal(got.tokens, want.tokens)
    assert captured.router.stats["graphs"] == graphs


def test_tiny_stream_on_the_card_equals_the_cpu(cuda):
    """A StreamSession on a tiny f32 engine on the card sends the messages
    of one on the CPU, on a stepped clock with every VAD window awaited."""
    import asyncio

    from sonicscribe_tpu_torch.serve.engine_async import ThreadedEngine
    from sonicscribe_tpu_torch.vad.model import EnergyVad

    frames, _, _ = stream_frames(TINY_STREAM_SPANS, seed=50)
    got = {}
    for device in ("cpu", cuda):
        tr, _ = _tiny_transcribers(device)
        engine = ThreadedEngine(tr, EnergyVad(device=device))
        try:
            got[str(device)] = asyncio.run(drive_stepped(AppConfig(), engine, frames))
        finally:
            engine.shutdown()
    kinds = [m["type"] for m in got["cpu"]]
    assert kinds.count("committed_output") == 2 and "tentative_output" in kinds
    assert got[str(cuda)] == got["cpu"]


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 16, 128), device=cuda, dtype=torch.float16)
    k = torch.zeros((1, 64, 4, 128), device=cuda, dtype=torch.float16)
    lens = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        decode_attention(q, k, k, lens)
    with pytest.raises(ValueError):
        decode_attention(q.float(), k.float(), k.float(), lens.cpu())


def _assert_w8a16_close(got, want):
    """float32 sums in another order: 1e-5 of the largest output; in bf16
    one more bf16 ulp of want for the final rounding."""
    want32 = want.float()
    tol = 1e-5 * want32.abs().max()
    if want.dtype == torch.bfloat16:
        exp = torch.floor(torch.log2(want32.abs().clamp(min=2.0**-126)))
        tol = tol + torch.exp2(exp - 7)
    err = (got.float() - want32).abs()
    assert got.dtype == want.dtype and bool((err <= tol).all()), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,N", [(1, 2048, 3072), (4, 5504, 2048), (37, 256, 80)])
def test_int8_matmul_kernels(cuda, dtype, B, K, N):
    g = torch.Generator(device=cuda).manual_seed(B)
    qt = quantize_tensor(torch.randn((3, K, N), generator=g, device=cuda) * 0.02)
    q, scale = qt["q"], qt["scale"]
    x = torch.randn((B, K), generator=g, device=cuda).to(dtype)
    before = dict(_build.launch_counts)

    _assert_w8a16_close(int8_matmul(x, q[1], scale[1]), int8_matmul_plain(x, q[1], scale[1]))
    _assert_w8a16_close(int8_matmul_stacked(x, q, scale, 2),
                        int8_matmul_stacked_plain(x, q, scale, 2))
    # integer sums are exact on both sides: equal outputs. The kernel
    # quantises x with the JAX recipe's IEEE division: the plain version on
    # CPU copies is that recipe
    got = int8_matmul_w8a8(x, q, scale, 2)
    assert torch.equal(got, _on_cpu(int8_matmul_w8a8_plain, x, q, scale, 2))
    for name in ("int8_matmul", "int8_matmul_stacked", "int8_matmul_w8a8"):
        assert _build.launch_counts[name] == before[name] + 1


# nano's flat (K, N): decoder qkv, o, gate_up, down; encoder q/k/v/o, fc1, fc2
NANO_FLAT = [(2048, 3072), (2048, 2048), (2048, 11008), (5504, 2048), (1024, 1024),
             (1024, 4096), (4096, 1024)]


@pytest.mark.parametrize("B", [9, 16, 17, 227, 419, 1024, 1536])
def test_int8_matmul_mma(cuda, B):
    """The tensor-core W8A16 design at prefill and encoder rows, across
    nano's (K, N): float32 sums in another order (the int8 -> bf16
    dequantisation and every product are exact)."""
    g = torch.Generator(device=cuda).manual_seed(B)
    x_all = torch.randn((B, 5504), generator=g, device=cuda).to(torch.bfloat16)
    for K, N in NANO_FLAT:
        qt = quantize_tensor(torch.randn((K, N), generator=g, device=cuda) * 0.02)
        x = x_all[:, :K].contiguous()
        before = dict(_build.launch_counts)
        got = int8_matmul(x, qt["q"], qt["scale"])
        assert _build.launch_counts["int8_matmul_mma"] == before["int8_matmul_mma"] + 1
        assert _build.launch_counts["int8_matmul"] == before["int8_matmul"] + 1
        _assert_w8a16_close(got, int8_matmul_plain(x, qt["q"], qt["scale"]))


@pytest.mark.parametrize("B,dtype,mma", [
    (8, torch.bfloat16, False), (9, torch.bfloat16, True), (419, torch.bfloat16, True),
    (9, torch.float32, False), (419, torch.float32, False),
])
def test_int8_matmul_mma_counter(cuda, B, dtype, mma):
    """The mma counter rises only for bf16 x with B > 8, on the flat and
    the stacked entry alike (layer 1 read by offset)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    qt = quantize_tensor(torch.randn((2, 256, 384), generator=g, device=cuda) * 0.02)
    x = torch.randn((B, 256), generator=g, device=cuda).to(dtype)
    before = dict(_build.launch_counts)
    _assert_w8a16_close(int8_matmul(x, qt["q"][0], qt["scale"][0]),
                        int8_matmul_plain(x, qt["q"][0], qt["scale"][0]))
    _assert_w8a16_close(int8_matmul_stacked(x, qt["q"], qt["scale"], 1),
                        int8_matmul_stacked_plain(x, qt["q"], qt["scale"], 1))
    assert _build.launch_counts["int8_matmul_mma"] == before["int8_matmul_mma"] + 2 * int(mma)
    assert _build.launch_counts["int8_matmul"] == before["int8_matmul"] + 1
    assert _build.launch_counts["int8_matmul_stacked"] == before["int8_matmul_stacked"] + 1


def test_int8_wrappers_reject_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 64), device=cuda)
    q = torch.zeros((3, 64, 32), dtype=torch.int8, device=cuda)
    scale = torch.ones((3, 1, 32), device=cuda)
    with pytest.raises(ValueError, match="out of range"):
        int8_matmul_stacked(x, q, scale, 3)
    with pytest.raises(ValueError, match="out of range"):
        int8_matmul_w8a8(x, q, scale, -1)
    with pytest.raises(TypeError):
        int8_matmul(x.half(), q[0], scale[0])
    with pytest.raises(TypeError):
        int8_matmul_stacked(x, q.float(), scale, 0)
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul(x.T.contiguous().T, q[0], scale[0])
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_matmul(x, q[0, :, :24].contiguous(), scale[0, :, :24].contiguous())
    with pytest.raises(ValueError, match="multiple of 4"):
        int8_matmul_w8a8(x[:, :62].contiguous(), q[:, :62].contiguous(), scale, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,N", [(1, 2048, 3072), (2, 1024, 384), (4, 5504, 2048),
                                   (37, 200, 128)])
def test_int4_matmul_kernels(cuda, dtype, B, K, N):
    g = torch.Generator(device=cuda).manual_seed(B)
    packed = pack_int4(torch.randint(-8, 8, (3, K, N), generator=g, device=cuda,
                                     dtype=torch.int8))
    scale = 0.02 + 0.01 * torch.rand((3, 1, N), generator=g, device=cuda)
    x = torch.randn((B, K), generator=g, device=cuda).to(dtype)
    before = dict(_build.launch_counts)

    _assert_w8a16_close(int4_matmul(x, packed[1], scale[1]),
                        int4_matmul_plain(x, packed[1], scale[1]))
    _assert_w8a16_close(int4_matmul_stacked(x, packed, scale, 2),
                        int4_matmul_stacked_plain(x, packed, scale, 2))
    # integer sums are exact on both sides: equal outputs. The kernel
    # quantises x with the JAX recipe's IEEE division, so the plain version
    # runs on the CPU (PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal instead)
    assert torch.equal(int4_matmul_w4a8(x, packed[1], scale[1]),
                       _on_cpu(int4_matmul_w4a8_plain, x, packed[1], scale[1]))
    assert torch.equal(int4_matmul_w4a8_stacked(x, packed, scale, 2),
                       _on_cpu(int4_matmul_w4a8_stacked_plain, x, packed, scale, 2))
    for name in ("int4_matmul", "int4_matmul_stacked", "int4_matmul_w4a8",
                 "int4_matmul_w4a8_stacked"):
        assert _build.launch_counts[name] == before[name] + 1


def test_int4_wrappers_reject_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 256), device=cuda)
    packed = torch.zeros((3, 128, 128), dtype=torch.int8, device=cuda)
    scale = torch.ones((3, 1, 128), device=cuda)
    with pytest.raises(ValueError, match="multiple of 128"):
        int4_matmul(x, packed[0, :, :64].contiguous(), scale[0, :, :64].contiguous())
    with pytest.raises(ValueError, match="even K"):
        int4_matmul_stacked(torch.zeros((2, 257), device=cuda), packed, scale, 0)
    with pytest.raises(ValueError, match="multiple of 4"):
        int4_matmul_w4a8(x[:, :132].contiguous(), packed[0, :66].contiguous(), scale[0])
    with pytest.raises(ValueError, match="out of range"):
        int4_matmul_stacked(x, packed, scale, 3)
    with pytest.raises(ValueError, match="out of range"):
        int4_matmul_w4a8_stacked(x, packed, scale, -1)
    with pytest.raises(TypeError):
        int4_matmul(x.half(), packed[0], scale[0])
    with pytest.raises(TypeError):
        int4_matmul_stacked(x, packed.float(), scale, 0)
    with pytest.raises(ValueError, match="contiguous"):
        int4_matmul(torch.zeros((256, 2), device=cuda).T, packed[0], scale[0])


def _on_cpu(fn, *args):
    """The plain version on CPU copies of the inputs, back on the card: the
    JAX recipe's arithmetic (an IEEE division for sx), the W4A8 oracle."""
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    return fn(*cpu).to(args[0].device)


def _nano_int4(device, seed):
    """Two-layer int4 stacks at nano's four decoder projections: (K, N) ->
    (packed [2, K/2, N], scale [2, 1, N])."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for K, N in [(2048, 3072), (2048, 2048), (2048, 11008), (5504, 2048)]:
        codes = torch.randint(-8, 8, (2, K, N), generator=g, device=device, dtype=torch.int8)
        out[K, N] = (pack_int4(codes), 0.02 + 0.01 * torch.rand((2, 1, N), generator=g,
                                                                    device=device))
    return out, g


@pytest.mark.parametrize("B", [1, 8, 9, 16, 17, 37, 64, 227])
def test_int4_w4a8_kernels_equal_the_recipe(cuda, B):
    """Both W4A8 entries quantise x in the kernel: equal bits with the
    plain version at nano's four projections, float32 and bf16 x; the mma
    counter rises exactly for the launches w4a8_uses_mma sends to the
    tensor cores."""
    weights, g = _nano_int4(cuda, B)
    for (K, N), (packed, scale) in weights.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((B, K), generator=g, device=cuda).to(dtype)
            before = dict(_build.launch_counts)
            got = int4_matmul_w4a8(x, packed[1], scale[1])
            got_st = int4_matmul_w4a8_stacked(x, packed, scale, 1)
            mma = _build.launch_counts["int4_matmul_w4a8_mma"] - before["int4_matmul_w4a8_mma"]
            assert mma == 2 * int(w4a8_uses_mma(B)), (K, N, dtype)
            assert torch.equal(got, _on_cpu(int4_matmul_w4a8_plain, x, packed[1], scale[1]))
            assert torch.equal(got_st, _on_cpu(int4_matmul_w4a8_stacked_plain, x, packed, scale, 1))


@pytest.mark.parametrize("B", [4, 37])
def test_int4_w4a8_crafted_rows(cuda, B):
    """Rows that pin the recipe: all zeros (the 1e-8 floor), x / sx exactly
    on .5 (half to even), the largest magnitude negative (-127), and
    values at +-127 after the clamp."""
    K, N = 256, 128
    g = torch.Generator(device=cuda).manual_seed(5)
    packed = pack_int4(torch.randint(-8, 8, (K, N), generator=g, device=cuda, dtype=torch.int8))
    scale = 0.02 + 0.01 * torch.rand((1, N), generator=g, device=cuda)
    x = torch.randn((B, K), generator=g, device=cuda)
    x[0] = 0.0
    x[1] = 0.0  # max|x| = 127 -> sx = 1: x / sx = v exactly
    x[1, :8] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5])
    x[2, 5] = -3.0 * x[2].abs().max()  # the largest magnitude is negative
    x[3] = torch.linspace(-1.0, 1.0, K, device=cuda) * 127.0  # both ends at +-127
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        got = int4_matmul_w4a8(xd, packed, scale)
        want = _on_cpu(int4_matmul_w4a8_plain, xd, packed, scale)
        assert torch.equal(got, want)
        assert not bool(got[0].any())  # a zero row stays zero


def test_int4_w4a8_launches_only_its_own_kernels(cuda):
    """A W4A8 call on the card runs no PyTorch kernel: in a profile of one
    call of each design, every kernel on the card is one of
    csrc/int4_matmul.cu's W4A8 kernels."""
    from torch.profiler import ProfilerActivity, profile

    weights, g = _nano_int4(cuda, 0)
    packed, scale = weights[2048, 3072]
    xs = [torch.randn((B, 2048), generator=g, device=cuda).to(torch.bfloat16) for B in (1, 64)]
    for x in xs:  # builds and loads the kernels outside the profile
        int4_matmul_w4a8_stacked(x, packed, scale, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x in xs:
            int4_matmul_w4a8_stacked(x, packed, scale, 1)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    assert names and all("w4a8" in n for n in names), names


# ---------------------------------------------------------------- the repairs and redesigns


# nano's projection weights by quantised key: (K, N) of one layer
NANO_PROJECTIONS = {
    "qkv_w": (2048, 3072), "o_w": (2048, 2048), "gate_up_w": (2048, 11008),
    "down_w": (5504, 2048), "q_w": (1024, 1024), "k_w": (1024, 1024), "v_w": (1024, 1024),
    "enc_o_w": (1024, 1024), "fc1_w": (1024, 4096), "fc2_w": (4096, 1024),
}


def test_div127_divides_on_the_card(cuda):
    """div127 on the card is an IEEE division (equal to the CPU's), where
    PyTorch's `/ 127.0` multiplies by the reciprocal."""
    g = torch.Generator(device=cuda).manual_seed(0)
    v = torch.rand((1 << 20,), generator=g, device=cuda) * 10.0
    assert torch.equal(div127(v).cpu(), div127(v.cpu()))


@pytest.mark.parametrize("key", sorted(NANO_PROJECTIONS))
def test_quantize_tensor_on_the_card_equals_the_cpu(cuda, key):
    """A tree quantised on the card (build_runtime's path) has the CPU's
    scales and codes, bit for bit, at nano's projection shapes (two layers,
    bf16 weights as nano-random's)."""
    K, N = NANO_PROJECTIONS[key]
    g = torch.Generator(device=cuda).manual_seed(K + N)
    w = (torch.randn((2, K, N), generator=g, device=cuda) * 0.02).to(torch.bfloat16)
    w[0, :, 0] = 0.0  # the 1e-8 floor
    got, want = quantize_tensor(w), quantize_tensor(w.cpu())
    assert torch.equal(got["scale"].cpu(), want["scale"])
    assert torch.equal(got["q"].cpu(), want["q"])


def _w8a8_designs(x, q, scale, layer):
    """Both W8A8 designs forced through the private launchers."""
    outs = []
    for launch in (im._launch_w8a8_cluster, im._launch_w8a8_mma):
        out, err = launch(x, q, scale, layer)
        assert err == 0, (launch.__name__, err)
        outs.append(out)
    return outs


@pytest.mark.parametrize("B", sorted({1, 2, 3, 4, 5, 8, W8A8_MMA_MIN_ROWS - 1, W8A8_MMA_MIN_ROWS,
                                      64}))
def test_int8_w8a8_equals_the_recipe(cuda, B):
    """W8A8 quantises x in the kernel: equal bits with the plain version
    (the JAX recipe) run on CPU copies, at nano's decode projections,
    float32 and bf16 x, at decode rows and either side of the design
    threshold, through the entry and both designs forced; the mma counter
    rises exactly from W8A8_MMA_MIN_ROWS rows."""
    g = torch.Generator(device=cuda).manual_seed(B)
    for K, N in NANO_PROJECTIONS.values():
        if (K, N) in ((1024, 1024), (1024, 4096), (4096, 1024)):
            continue  # the encoder's: W8A8 serves decode only
        qt = quantize_tensor(torch.randn((2, K, N), generator=g, device=cuda) * 0.02)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((B, K), generator=g, device=cuda).to(dtype)
            before = _build.launch_counts["int8_matmul_w8a8_mma"]
            got = int8_matmul_w8a8(x, qt["q"], qt["scale"], 1)
            assert _build.launch_counts["int8_matmul_w8a8_mma"] - before == int(
                B >= W8A8_MMA_MIN_ROWS)
            want = _on_cpu(int8_matmul_w8a8_plain, x, qt["q"], qt["scale"], 1)
            assert torch.equal(got, want)
            for out in _w8a8_designs(x, qt["q"], qt["scale"], 1):
                assert torch.equal(out, want)


@pytest.mark.parametrize("B", [4, 8])
def test_int8_w8a8_crafted_rows(cuda, B):
    """Rows that pin the recipe, as for W4A8: all zeros (the 1e-8 floor),
    x / sx exactly on .5 (half to even), the largest magnitude negative,
    and both ends at +-127."""
    K, N = 256, 128
    g = torch.Generator(device=cuda).manual_seed(5)
    qt = quantize_tensor(torch.randn((1, K, N), generator=g, device=cuda) * 0.02)
    x = torch.randn((B, K), generator=g, device=cuda)
    x[0] = 0.0
    x[1] = 0.0  # max|x| = 127 -> sx = 1: x / sx = v exactly
    x[1, :8] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5])
    x[2, 5] = -3.0 * x[2].abs().max()  # the largest magnitude is negative
    x[3] = torch.linspace(-1.0, 1.0, K, device=cuda) * 127.0  # both ends at +-127
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        want = _on_cpu(int8_matmul_w8a8_plain, xd, qt["q"], qt["scale"], 0)
        for got in [int8_matmul_w8a8(xd, qt["q"], qt["scale"], 0),
                    *_w8a8_designs(xd, qt["q"], qt["scale"], 0)]:
            assert torch.equal(got, want)
            assert not bool(got[0].any())  # a zero row stays zero


def _kernel_names(fn):
    """The names of the kernels one call of fn runs on the card."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # builds and loads the kernels outside the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def test_int8_w8a8_launches_only_its_own_kernels(cuda):
    """A W8A8 call runs no PyTorch kernel: at B 1 exactly one kernel (the
    cluster split-K kernel under its W8A8 policy, no split-K pass), and at
    8, the threshold and 64 rows every kernel on the card is a W8A8 kernel
    of csrc/int8_matmul.cu."""
    g = torch.Generator(device=cuda).manual_seed(0)
    qt = quantize_tensor(torch.randn((2, 2048, 3072), generator=g, device=cuda) * 0.02)
    for B in (1, 8, W8A8_MMA_MIN_ROWS, 64):
        x = torch.randn((B, 2048), generator=g, device=cuda).to(torch.bfloat16)
        names = _kernel_names(lambda: int8_matmul_w8a8(x, qt["q"], qt["scale"], 1))
        assert names and all("w8a8" in n.lower() for n in names), names
        if B == 1:
            assert len(names) == 1, names


@pytest.mark.parametrize("B", [1, 2, 3, 4, 5, 8])
def test_int8_w8a16_decode_rows(cuda, B):
    """The cluster split-K W8A16 design at decode rows, stacked and flat
    (below the tensor-core threshold), at nano's decoder projections:
    within tolerance of the plain version, two runs bit-equal, the stacked
    call one launch of one kernel."""
    g = torch.Generator(device=cuda).manual_seed(B)
    for K, N in [(2048, 3072), (2048, 2048), (2048, 11008), (5504, 2048)]:
        qt = quantize_tensor(torch.randn((2, K, N), generator=g, device=cuda) * 0.02)
        q, scale = qt["q"], qt["scale"]
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((B, K), generator=g, device=cuda).to(dtype)
            got = int8_matmul_stacked(x, q, scale, 1)
            _assert_w8a16_close(got, int8_matmul_stacked_plain(x, q, scale, 1))
            assert torch.equal(got, int8_matmul_stacked(x, q, scale, 1))
            flat = int8_matmul(x, q[1], scale[1])
            _assert_w8a16_close(flat, int8_matmul_plain(x, q[1], scale[1]))
            assert torch.equal(flat, got)  # flat is a stack of one: the same kernel
    names = _kernel_names(lambda: int8_matmul_stacked(x, q, scale, 1))
    assert len(names) == 1, names


@pytest.mark.parametrize("B", [1, 2, 4, 5, 8, 9, 16, 37, 64, 227])
def test_int4_w4a16_designs(cuda, B):
    """W4A16 flat and stacked at nano's four projections, float32 and bf16
    x, both sides of the tensor-core threshold and ragged B: within
    tolerance of the plain version; the mma counter rises exactly where
    w4a16_uses_mma says."""
    weights, g = _nano_int4(cuda, B + 100)
    for (K, N), (packed, scale) in weights.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((B, K), generator=g, device=cuda).to(dtype)
            before = dict(_build.launch_counts)
            got = int4_matmul(x, packed[1], scale[1])
            got_st = int4_matmul_stacked(x, packed, scale, 1)
            mma = _build.launch_counts["int4_matmul_w4a16_mma"] - before["int4_matmul_w4a16_mma"]
            assert mma == 2 * int(w4a16_uses_mma(B, dtype)), (K, N, dtype)
            assert _build.launch_counts["int4_matmul"] == before["int4_matmul"] + 1
            want = int4_matmul_plain(x, packed[1], scale[1])
            _assert_w8a16_close(got, want)
            _assert_w8a16_close(got_st, want)
            assert torch.equal(got_st, int4_matmul_stacked(x, packed, scale, 1))


@pytest.mark.parametrize("B", [1, 4, 32])
def test_log_mel_kernel_batched(cuda, B):
    """One launch for B rows of noise at different levels (the batcher's
    ring prefill), each row equal to the kernel on that row alone and
    within 1e-4 raw log10 of the plain version; rows 16-byte aligned by
    their stride."""
    cfg = MelConfig()
    basis, fb = device_tables(cfg, cuda)
    rng = np.random.default_rng(B)
    x = torch.from_numpy(np.stack([(0.02 + 0.1 * i / B) * rng.standard_normal(20 * 1024)
                                   for i in range(B)]).astype(np.float32)).to(cuda)
    padded = torch.nn.functional.pad(x[:, None], (200, 200), mode="reflect")[:, 0]
    before = _build.launch_counts["log_mel"]
    got = log_mel_frames(padded, basis, fb, 128, cfg.hop_length)
    assert _build.launch_counts["log_mel"] - before == 1 and got.shape == (B, 128, cfg.n_mels)
    want = log_mel_frames_plain(padded, basis, fb, 128, cfg.hop_length)
    assert (got - want).abs().max().item() <= 1e-4
    for i in (0, B - 1):
        row, err = tmel._launch(padded[i].contiguous(), basis, fb, 128, cfg.hop_length,
                                tmel.frames_per_block(128, _build.n_sms(cuda), B))
        assert err == 0 and torch.equal(row, got[i])


def test_batched_engine_on_the_card_equals_the_cpu(cuda):
    """tiny f32 on the batched engine: the card (warmup's graphs, kernels)
    gives the CPU's tokens for concurrent requests of mixed budgets and
    hotwords, and a stepped stream session the CPU's messages; the stream
    captures no graph after warmup."""
    import asyncio

    from sonicscribe_tpu_torch.engine.batcher import BatchedEngine
    from sonicscribe_tpu_torch.vad.model import EnergyVad

    reqs = [(_speech(0.8 + 0.5 * i, seed=30 + i), budget, hot) for i, (budget, hot) in
            enumerate([(8, None), (24, ["gpu"]), (15, None), (40, None)])]
    frames, _, _ = stream_frames(TINY_STREAM_SPANS, seed=50)
    tokens, msgs, graphs = {}, {}, {}
    for device in ("cpu", cuda):
        tr, _ = _tiny_transcribers(device)
        engine = BatchedEngine(tr, EnergyVad(device=device), slots=4, max_decode_tokens=64,
                               n_streams=4)
        engine.warmup()

        async def run(engine=engine):
            rs = await asyncio.gather(*[engine.transcribe(a, 16000, max_new_tokens=b, hotwords=h)
                                        for a, b, h in reqs])
            return [r.tokens for r in rs]

        try:
            tokens[str(device)] = asyncio.run(run())
            before = engine.router.stats["graphs"]
            msgs[str(device)] = asyncio.run(drive_stepped(AppConfig(), engine, frames))
            graphs[str(device)] = engine.router.stats["graphs"] - before
        finally:
            engine.shutdown()
    for a, b in zip(tokens[str(cuda)], tokens["cpu"]):
        np.testing.assert_array_equal(a, b)
    assert msgs[str(cuda)] == msgs["cpu"] and graphs[str(cuda)] == 0
    assert [m["type"] for m in msgs["cpu"]].count("committed_output") == 2
