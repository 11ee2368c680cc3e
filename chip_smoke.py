#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sonicscribe_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package. Phases, each of which
exits non-zero on failure:

1. build: nvcc compiles every kernel of csrc/ for sm_90a, in parallel.
2. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the main path's shapes, with its stated tolerance; then its time
   beside its plain version's, a PyTorch library call's (a yardstick the
   port never calls) and its bound at the H100's 3.35 TB/s and 67 TFLOP/s
   float32 (NVIDIA data sheet, SXM).
3. main path: build_runtime("nano-random") in bf16 at full width, then the
   file-transcription path of POST /transcribe/file (decode_audio +
   transcribe_file_stream) on three 16 kHz WAVs made from a seed: ~3 s,
   ~12 s and ~35 s with silences (VAD splits it, one span is cut long).
   The launch counters are set to 0 before each request and read after:
   the mel kernel must have run once per segment and decode attention once
   per layer per decode step.
4. reference: tiny() in float32 gives the same tokens on the card as on
   the CPU (where the tests hold it against the JAX package), and nano's
   prefill logits are finite.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time

import numpy as np

SR = 16000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
ATTN_TOL = 2e-5  # same inputs, float32 sums in another order
MEL_TOL = 1e-3  # normalized log-mel; float32 DFT sums in another order
SEED = 0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(*args) -> None:
    print(*args, flush=True)


def speech(sec: float, seed: int) -> np.ndarray:
    """Speech-like test signal: four partials under a 3 Hz envelope + noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * sec)) / SR
    env = 0.5 * (1 + np.sin(2 * np.pi * 3 * t))
    x = 0.25 * env * sum(np.sin(2 * np.pi * f * t) for f in (200, 700, 1500, 2600))
    return (x + 0.002 * rng.standard_normal(len(t))).astype(np.float32)


def silence(sec: float, seed: int) -> np.ndarray:
    return (0.0006 * np.random.default_rng(seed).standard_normal(int(SR * sec))).astype(
        np.float32
    )


class Timer:
    """Median device time of a call, each launch timed with CUDA events
    after the L2 cache is overwritten (the main path reaches these kernels
    with the cache full of other layers' weights). A spin kernel ahead of
    each start event keeps the card busy while the host enqueues the call,
    so host-side launch cost is not counted as device time."""

    SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's boost clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 30) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, timer):
    import torch.nn.functional as F

    from sonicscribe_tpu_torch.audio.mel import (
        MelConfig,
        device_tables,
        normalize_log_mel,
        reflect_pad,
    )
    from sonicscribe_tpu_torch.models.config import nano
    from sonicscribe_tpu_torch.ops.decode_attention import (
        decode_attention_cuda,
        decode_attention_plain,
    )
    from sonicscribe_tpu_torch.ops.mel import log_mel_frames_cuda, log_mel_frames_plain

    dec = nano().decoder
    nh, nkv, hd = dec.n_heads, dec.n_kv_heads, dec.head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def cache(S, M, dtype):
        # one layer of a [2, S, M, nkv, hd] cache: the strided view decode_step passes
        k = torch.randn((2, S, M, nkv, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((2, S, M, nkv, hd), generator=gen, device="cuda").to(dtype)
        q = torch.randn((S, nh, hd), generator=gen, device="cuda").to(dtype)
        return q, k[1], v[1]

    # ---- decode attention: correctness at nano heads ----
    attn_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for S in (1, 4):
            for M in (803, 1024):
                q, k, v = cache(S, M, dtype)
                cases = [[L] * S for L in (0, 1, 127, 128, M - 1, M)]
                if S == 4:
                    cases.append([0, 127, 128, M - 1])
                for lens_list in cases:
                    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
                    got = decode_attention_cuda(q, k, v, lens)
                    want = decode_attention_plain(q, k, v, lens)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    check(np.isfinite(err) and err <= ATTN_TOL,
                          f"decode_attention {dtype} S={S} M={M} lens={lens_list}: "
                          f"max err {err} > {ATTN_TOL}")
                    attn_err = max(attn_err, err)
    log(f"decode_attention: max abs err {attn_err:.3g} <= {ATTN_TOL} "
        f"(f32 and bf16 caches, S in 1,4, M in 803,1024, lens 0,1,127,128,M-1,M)")

    # ---- decode attention: time at main-path shapes (bf16, batch 1) ----
    # M = 3 prefix + bucket/8 audio + 160 suffix + 256 new tokens
    attn_rows = []
    for S, M in ((1, 675), (1, 803), (4, 1024)):
        q, k, v = cache(S, M, torch.bfloat16)
        L = M - 1
        lens = torch.full((S,), L, dtype=torch.int32, device="cuda")
        kq = k[:, : L + 1].transpose(1, 2).contiguous()  # [S, nkv, L+1, hd]
        vq = v[:, : L + 1].transpose(1, 2).contiguous()
        qq = q[:, :, None, :]  # [S, nh, 1, hd]
        ms = timer.ms(lambda: decode_attention_cuda(q, k, v, lens))
        plain_ms = timer.ms(lambda: decode_attention_plain(q, k, v, lens))
        lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(qq, kq, vq, enable_gqa=True))
        esize = 2
        n_bytes = S * (nh * hd * esize + 2 * (L + 1) * nkv * hd * esize + nh * hd * 4 + 4)
        flops = S * 4 * nh * hd * (L + 1)
        b_ms, b_by = bound_ms(n_bytes, flops)
        log(f"decode_attention S={S} M={M} lens={L} bf16: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        attn_rows.append(dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              library_ms=lib_ms))

    # ---- log-mel: correctness at every bucket, ragged lengths ----
    cfg = MelConfig()
    basis, fb = device_tables(cfg, torch.device("cuda"))
    mel_err = 0.0
    for i, bucket in enumerate((128, 256, 512, 1024, 2048, 3072)):
        n = int(bucket * 0.8) * cfg.hop_length + 97 + 13 * i
        x = torch.from_numpy(speech(n / SR, seed=10 + i)).cuda()
        padded, nf = reflect_pad(x, cfg)
        raw = log_mel_frames_cuda(padded, basis, fb, nf, cfg.hop_length)
        raw_plain = log_mel_frames_plain(padded, basis, fb, nf, cfg.hop_length)
        got = normalize_log_mel(raw, cfg, bucket)
        want = normalize_log_mel(raw_plain, cfg, bucket)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        raw_err = (raw - raw_plain).abs().max().item()
        check(got.shape == (bucket, cfg.n_mels), f"log_mel shape {tuple(got.shape)}")
        check(np.isfinite(err) and err <= MEL_TOL,
              f"log_mel bucket {bucket}: max err {err} > {MEL_TOL}")
        mel_err = max(mel_err, err)
        log(f"log_mel bucket {bucket} ({nf} frames): max abs err {err:.3g} <= {MEL_TOL} "
            f"(raw log10 {raw_err:.3g})")

    # ---- log-mel: time at the ~12 s request's shape ----
    mel_rows = []
    for sec in (12.0, 30.72):
        x = torch.from_numpy(speech(sec, seed=3)).cuda()
        padded, nf = reflect_pad(x, cfg)
        window = torch.hann_window(cfg.n_fft, periodic=True, device="cuda")

        def library():
            spec = torch.stft(x, cfg.n_fft, cfg.hop_length, window=window, center=True,
                              pad_mode="reflect", return_complex=True)
            power = spec[:, :nf].abs() ** 2
            return torch.log10(torch.clamp(power.T @ fb, min=1e-10))

        ms = timer.ms(lambda: log_mel_frames_cuda(padded, basis, fb, nf, cfg.hop_length))
        plain_ms = timer.ms(lambda: log_mel_frames_plain(padded, basis, fb, nf, cfg.hop_length))
        lib_ms = timer.ms(library)
        n_bins = cfg.n_freq_bins
        n_bytes = 4 * (padded.numel() + basis.numel() + fb.numel() + nf * cfg.n_mels)
        flops = nf * (2 * cfg.n_fft * 2 * n_bins + 3 * n_bins + 2 * n_bins * cfg.n_mels)
        b_ms, b_by = bound_ms(n_bytes, flops)
        log(f"log_mel {nf} frames: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"stft+matmul {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        mel_rows.append(dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms))
    return attn_err, attn_rows[0], mel_err, mel_rows[0]


async def _collect(gen) -> list:
    return [m async for m in gen]


def main_path_phase(torch):
    from sonicscribe_tpu_torch.audio.wav import write_wav
    from sonicscribe_tpu_torch.config import AppConfig
    from sonicscribe_tpu_torch.ops import _build
    from sonicscribe_tpu_torch.serve.decode import decode_audio
    from sonicscribe_tpu_torch.serve.files import FileTranscriptionConfig, transcribe_file_stream
    from sonicscribe_tpu_torch.serve.runtime import build_runtime

    config = AppConfig()
    t0 = time.perf_counter()
    engine, vad, info = build_runtime("nano-random", "energy", config, seed=SEED)
    torch.cuda.synchronize()
    log(f"nano-random on {info['device_name']}: {info['params']} params, "
        f"init {time.perf_counter() - t0:.1f} s")
    n_layers = engine.transcriber.cfg.decoder.n_layers

    payloads = {
        "3s": speech(3.0, 1),
        "12s": speech(12.0, 2),
        "35s": np.concatenate([silence(0.5, 3), speech(24.0, 4), silence(2.0, 5),
                               speech(7.0, 6), silence(1.5, 7)]),
    }
    launches = {"decode_attention": 0, "log_mel": 0}
    torch.cuda.reset_peak_memory_stats()
    try:
        for name, audio in payloads.items():
            wav = write_wav(audio, SR)
            file_cfg = FileTranscriptionConfig.from_dict(
                {}, default_threshold=config.vad_speech_threshold
            )
            file_cfg.max_new_tokens = config.file_max_new_tokens
            file_cfg.concurrency = engine.concurrency_hint
            steps0 = engine.stats["decode_steps"]
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            decoded = decode_audio(wav, f"{name}.wav", engine.transcriber.device)
            msgs = asyncio.run(_collect(
                transcribe_file_stream(decoded, engine, vad, file_cfg, f"{name}.wav")
            ))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(_build.launch_counts)
            steps = engine.stats["decode_steps"] - steps0

            n_seg = msgs[0].get("total_segments", 0)
            types = [m["type"] for m in msgs]
            want = (["initialization", "segments_summary"] + ["segment_result"] * n_seg
                    + ["final_summary"])
            errors = [m for m in msgs if m["type"] == "segment_error"]
            check(not errors, f"{name}: segment errors {errors}")
            check(n_seg >= 1 and types == want, f"{name}: NDJSON types {types}")
            check(counts["log_mel"] == n_seg,
                  f"{name}: log_mel launched {counts['log_mel']} times for {n_seg} segments")
            check(steps > 0 and counts["decode_attention"] == n_layers * steps,
                  f"{name}: decode_attention launched {counts['decode_attention']} times "
                  f"for {steps} decode steps x {n_layers} layers")
            if name == "35s":
                check(n_seg >= 3 and any(m["is_long_segment"] for m in msgs[1]["segments"]),
                      f"35s: expected a VAD split and a long-segment cut, got {msgs[1]}")
            for kname in launches:
                launches[kname] += counts[kname]
            tokens = steps + n_seg  # each segment: one token from prefill + one per step
            duration = len(decoded) / SR
            log(f"request {name}: {n_seg} segments, wall {wall:.3f} s, RTF "
                f"{wall / duration:.4f}, {tokens} tokens, {tokens / wall:.1f} tokens/s, "
                f"launches {counts}, text[:40]={msgs[-1]['full_text'][:40]!r}")
        log(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return engine, launches
    except BaseException:
        engine.shutdown()
        raise


def profile_phase(torch, engine):
    """Where a request's time goes: host wall vs device busy time for one
    3 s request with a 32-token budget, and the top kernels by device time
    (torch.profiler; informational, after the counted main path)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tr = engine.transcriber
    audio = speech(3.0, 40)
    tr.transcribe(audio, SR, max_new_tokens=32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = tr.transcribe(audio, SR, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.transcribe(audio, SR, max_new_tokens=32)
        torch.cuda.synchronize()
    # kernels only: an operator's own entry repeats its kernels' device time
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    busy_ms = sum(dev_us(e) for e in events) / 1e3
    check(busy_ms > 0, "the profiler saw no device time")
    log(f"profile: 3 s request, 32-token budget: wall {wall * 1e3:.1f} ms (unprofiled), "
        f"mel {r.timings['mel_s'] * 1e3:.1f} ms host, device busy {busy_ms:.1f} ms "
        f"(idle share {max(0.0, 1 - busy_ms / (wall * 1e3)):.3f})")
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")


def reference_phase(torch, engine):
    """tiny() f32: card vs CPU tokens; nano prefill logits finite."""
    from sonicscribe_tpu_torch.audio.mel import log_mel_spectrogram
    from sonicscribe_tpu_torch.engine.transcriber import (
        MAX_SUFFIX_TOKENS,
        Transcriber,
        assemble_prompt,
    )
    from sonicscribe_tpu_torch.models.config import tiny
    from sonicscribe_tpu_torch.models.glm_asr import prefill_kv
    from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer, build_prompt
    from sonicscribe_tpu_torch.models.weights import init_random

    cfg = tiny()

    def scaled(tree, device):  # x4 so the random model's tokens vary
        if isinstance(tree, dict):
            return {k: scaled(v, device) for k, v in tree.items()}
        return (tree * 4.0).to(device)

    base = init_random(cfg, seed=SEED + 1, dtype=torch.float32, device="cpu")
    trs = {d: Transcriber(cfg, scaled(base, d), ByteTokenizer(cfg), prefill_buckets=(128, 256))
           for d in ("cpu", "cuda")}
    for sec, sr in ((1.3, 16000), (2.2, 16000)):
        audio = speech(sec, seed=20)
        a = trs["cpu"].transcribe(audio, sr, max_new_tokens=24)
        b = trs["cuda"].transcribe(audio, sr, max_new_tokens=24)
        check(len(a.tokens) > 0 and np.array_equal(a.tokens, b.tokens),
              f"tiny f32 tokens differ: cpu {a.tokens} cuda {b.tokens}")
        log(f"reference: tiny f32 {sec} s, {len(a.tokens)} tokens equal on cuda and cpu")

    tr = engine.transcriber
    x = torch.from_numpy(speech(3.0, 30)).cuda()
    mel = log_mel_spectrogram(x, tr.mel_cfg, pad_to_frames=512)[None].to(tr.dtype)
    prompt = build_prompt(tr.tokenizer, tr.cfg)
    suffix = np.full((MAX_SUFFIX_TOKENS,), tr.cfg.pad_id, np.int32)
    suffix[: len(prompt.suffix_ids)] = prompt.suffix_ids
    with torch.inference_mode():
        buf, total = assemble_prompt(
            tr.params, tr.cfg, mel, 300, torch.from_numpy(prompt.prefix_ids).cuda(),
            torch.from_numpy(suffix).cuda(), len(prompt.suffix_ids),
        )
        _, _, logits = prefill_kv(tr.params, tr.cfg, buf, total)
    check(tuple(logits.shape) == (1, tr.cfg.decoder.vocab_size) and logits.dtype == torch.float32,
          f"nano logits {tuple(logits.shape)} {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), "nano prefill logits are not finite")
    log("reference: nano prefill logits finite, shape", tuple(logits.shape))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    from sonicscribe_tpu_torch.device import resolve_device
    from sonicscribe_tpu_torch.ops import _build

    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    log(smi[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    reports = _build.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s for {sorted(reports) or 'none (cached)'}")
    for name, report in reports.items():
        regs = [ln.strip() for ln in report.splitlines() if "registers" in ln]
        log(f"  {name}: {'; '.join(regs)}")

    timer = Timer(torch)
    attn_err, attn_row, mel_err, mel_row = kernel_phase(torch, timer)
    del timer

    engine, launches = main_path_phase(torch)
    try:
        profile_phase(torch, engine)
        reference_phase(torch, engine)
    finally:
        engine.shutdown()

    kernels = [
        dict(name="decode_attention", route="cuda",
             source="sonicscribe_tpu_torch/csrc/decode_attention.cu",
             replaces="sonicscribe_tpu/ops/decode_attention.py:34",
             launches=launches["decode_attention"], max_abs_err=attn_err, **attn_row),
        dict(name="log_mel", route="cuda",
             source="sonicscribe_tpu_torch/csrc/log_mel.cu",
             replaces="sonicscribe_tpu/ops/mel_pallas.py:53",
             launches=launches["log_mel"], max_abs_err=mel_err, **mel_row),
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} never launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
