"""Checkpoint runbook: convert -> load -> transcribe -> parity report, without JAX.

The port's counterpart of the JAX package's ``tools/verify_checkpoint.py``,
the first thing to run on a machine that has the GLM-ASR-Nano-2512 weights:

    python -m sonicscribe_tpu_torch.tools.verify_checkpoint <hf_or_native_dir> \
        [--out <native_dir>] [--wav golden.wav --expect "transcript"] [--int8] \
        [--device cpu]

Steps and what each proves:
  1. derive   — architecture derived from the checkpoint's config.json
                (convert_weights.cfg_from_hf_config); fails loudly listing
                the missing fields if the real layout differs.
  2. convert  — HF -> native npz through HF_NAME_MAP with per-tensor shape
                checks and an unconsumed-tensor report.
  3. load     — native loader (models/weights.py) + tokenizer carry-over,
                onto the device.
  4. twin     — greedy tokens of the port's Transcriber on the device in
                float32 against the independent reference
                (tools/torch_reference.py) on the CPU in float32, the same
                converted tree and the same log-mel: token for token.
                Skipped for int8 trees (the reference takes float weights).
  5. mel      — the port's log-mel against transformers'
                WhisperFeatureExtractor (<= 1e-3), skipped where
                transformers is not installed.
  6. wav      — transcribe the given WAV(s); compare to --expect text when
                given (the real-weights acceptance test).

Exit code 0 = every step that ran passed; the report marks skipped steps.
--device: the card unless 'cpu'.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

TWIN_TOKENS = 16


def _ok(name: str, detail: str = "") -> dict:
    return {"step": name, "status": "ok", "detail": detail}


def _fail(name: str, detail: str) -> dict:
    return {"step": name, "status": "FAIL", "detail": detail}


def _skip(name: str, detail: str) -> dict:
    return {"step": name, "status": "skipped", "detail": detail}


def _cut(tokens, cfg) -> list[int]:
    """Greedy tokens up to the first EOS or pad, which is dropped (as
    Transcriber.transcribe cuts them)."""
    out: list[int] = []
    for t in tokens:
        if int(t) in (cfg.eos_id, cfg.pad_id):
            break
        out.append(int(t))
    return out


def _twin(cfg, params, tokenizer, device) -> dict:
    """The port's Transcriber in float32 on `device` against the reference
    on the CPU, on a 0.5 s 440 Hz probe."""
    from sonicscribe_tpu_torch.audio.mel import frame_count, log_mel_spectrogram
    from sonicscribe_tpu_torch.engine.transcriber import Transcriber
    from sonicscribe_tpu_torch.models.tokenizer import build_prompt
    from sonicscribe_tpu_torch.tools.torch_reference import transcribe_torch

    sr = 16000
    t = np.arange(sr // 2) / sr
    probe = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    tr = Transcriber(cfg, _map(params, lambda x: x.to(device, torch.float32)), tokenizer)
    with torch.inference_mode():
        # the log-mel the Transcriber computes for this probe, for the reference
        x = tr.prepare_audio(probe, sr)
        frames = max(1, frame_count(int(x.shape[0]), tr.mel_cfg))
        mel = log_mel_spectrogram(x, tr.mel_cfg, pad_to_frames=tr._pick_bucket(frames))
        mel = mel[:frames].cpu().numpy()
    got = [int(t) for t in tr.transcribe(probe, sr, max_new_tokens=TWIN_TOKENS).tokens]
    prompt = build_prompt(tokenizer, cfg)
    want = _cut(transcribe_torch(_map(params, lambda x: x.float().cpu().numpy()), cfg, mel,
                                 prompt.prefix_ids, prompt.suffix_ids, TWIN_TOKENS), cfg)
    if got == want:
        return _ok("twin", f"token-exact over {len(want)} tokens")
    return _fail("twin", f"port {got} != reference {want}")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _mel_step(cfg) -> dict:
    try:
        from transformers import WhisperFeatureExtractor
    except ImportError as e:
        return _skip("mel", f"transformers unavailable: {e}")
    from sonicscribe_tpu_torch.audio.mel import MelConfig, log_mel_spectrogram

    try:
        mc = MelConfig(n_mels=cfg.encoder.n_mels)
        fe = WhisperFeatureExtractor(feature_size=mc.n_mels, sampling_rate=mc.sampling_rate)
        rng = np.random.default_rng(0)
        probe = rng.standard_normal(mc.sampling_rate).astype(np.float32) * 0.2
        ours = log_mel_spectrogram(probe, mc, device="cpu").numpy().T  # [n_mels, T]
        theirs = fe(probe, sampling_rate=mc.sampling_rate, padding="do_not_pad",
                    return_tensors="np")["input_features"][0]
        if ours.shape != theirs.shape:
            raise ValueError(f"mel shape mismatch: ours {ours.shape} vs HF {theirs.shape}")
        err = float(np.abs(ours - theirs).max())
        if err <= 1e-3:
            return _ok("mel", f"max |diff| = {err:.2e} (tol 1e-3)")
        return _fail("mel", f"max |diff| = {err:.2e} > 1e-3")
    except Exception as e:
        return _fail("mel", f"{type(e).__name__}: {e}")


def verify(
    src: str,
    out: str | None = None,
    wavs: list[str] | None = None,
    expects: list[str] | None = None,
    int8: bool = False,
    max_new_tokens: int = 48,
    device=None,
) -> list[dict]:
    from sonicscribe_tpu_torch.device import resolve_device
    from sonicscribe_tpu_torch.models.glm_asr import param_count
    from sonicscribe_tpu_torch.models.weights import NATIVE_CONFIG, load_checkpoint
    from sonicscribe_tpu_torch.tools.convert_weights import (
        cfg_from_hf_config,
        convert_hf_checkpoint,
    )

    device = resolve_device(device)
    report: list[dict] = []

    # ---- 1+2: derive + convert (HF input only) ----
    if os.path.exists(os.path.join(src, NATIVE_CONFIG)):
        native_dir = src
        report.append(_skip("derive", "input is already a native checkpoint"))
        report.append(_skip("convert", "input is already a native checkpoint"))
    else:
        try:
            cfg = cfg_from_hf_config(src)
            enc, dec = cfg.encoder, cfg.decoder
            report.append(_ok(
                "derive",
                f"encoder {enc.n_layers}L d={enc.d_model} mels={enc.n_mels}; "
                f"decoder {dec.n_layers}L d={dec.d_model} "
                f"heads={dec.n_heads}/{dec.n_kv_heads} hd={dec.head_dim} "
                f"ffn={dec.ffn_hidden} vocab={dec.vocab_size} "
                f"rope_partial={dec.partial_rotary_factor} "
                f"tie={dec.tie_embeddings}; adapter stack={cfg.adapter_stack} "
                f"hidden={cfg.adapter_hidden}; ids pad={cfg.pad_id} eos={cfg.eos_id} "
                f"audio=[{cfg.audio_start_id},{cfg.audio_end_id}]",
            ))
        except Exception as e:
            report.append(_fail("derive", str(e)))
            return report
        native_dir = out or tempfile.mkdtemp(prefix="sonic_ckpt_")
        warnings: list[str] = []
        try:
            convert_hf_checkpoint(src, native_dir, cfg, int8=int8, progress=warnings.append)
            report.append(_ok("convert", "; ".join(warnings)))
        except Exception as e:
            report.append(_fail("convert", str(e)))
            return report

    # ---- 3: load ----
    try:
        cfg, params, tokenizer = load_checkpoint(native_dir, device=device)
        report.append(_ok("load", f"{param_count(params) / 1e9:.2f}B params on {device}, "
                                  f"tokenizer={type(tokenizer).__name__}"))
    except Exception as e:
        report.append(_fail("load", str(e)))
        return report

    # ---- 4: twin token-exactness (float32 both sides; int8 trees skip:
    # the reference consumes unquantized weights) ----
    if int8:
        report.append(_skip("twin", "int8 tree (the reference consumes float weights)"))
    else:
        try:
            report.append(_twin(cfg, params, tokenizer, device))
        except Exception as e:
            report.append(_fail("twin", f"{type(e).__name__}: {e}"))

    # ---- 5: mel parity vs transformers ----
    report.append(_mel_step(cfg))

    # ---- 6: golden WAVs ----
    if not wavs:
        report.append(_skip("wav", "no --wav given"))
        return report
    from sonicscribe_tpu_torch.audio.wav import read_wav
    from sonicscribe_tpu_torch.engine.transcriber import Transcriber

    tr = Transcriber(cfg, params, tokenizer)
    expects = expects or []
    for i, path in enumerate(wavs):
        try:
            with open(path, "rb") as f:
                audio, sr = read_wav(f.read())
            r = tr.transcribe(audio, sr, max_new_tokens=max_new_tokens)
            detail = f"{os.path.basename(path)!r} -> {r.text!r}"
            if i < len(expects):
                want, got = expects[i].strip().lower(), r.text.strip().lower()
                report.append(_ok(f"wav[{i}]", detail) if want == got
                              else _fail(f"wav[{i}]", f"{detail}; expected {want!r}"))
            else:
                report.append(_ok(f"wav[{i}]", detail))
        except Exception as e:
            report.append(_fail(f"wav[{i}]", f"{type(e).__name__}: {e}"))
    return report


def print_report(report: list[dict]) -> bool:
    """Print the report, one line a step and a verdict. -> passed."""
    failed = [r for r in report if r["status"] == "FAIL"]
    width = max(len(r["step"]) for r in report)
    for r in report:
        mark = {"ok": "PASS", "FAIL": "FAIL", "skipped": "SKIP"}[r["status"]]
        print(f"  [{mark}] {r['step']:<{width}}  {r['detail']}")
    print(
        f"checkpoint verification: {'FAILED' if failed else 'PASSED'} "
        f"({sum(r['status'] == 'ok' for r in report)} ok, {len(failed)} failed, "
        f"{sum(r['status'] == 'skipped' for r in report)} skipped)"
    )
    return not failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Convert, load, and parity-check a GLM-ASR checkpoint")
    ap.add_argument("src", help="HF checkpoint dir or native (converted) dir")
    ap.add_argument("--out", help="where to write the converted native checkpoint "
                                  "(default: temp dir)")
    ap.add_argument("--wav", action="append", default=[],
                    help="golden WAV to transcribe (repeatable)")
    ap.add_argument("--expect", action="append", default=[],
                    help="expected transcript for the i-th --wav (repeatable)")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--device", default=None, help="'cpu' or a CUDA device (default: the card)")
    ap.add_argument("--json", action="store_true", help="machine output")
    args = ap.parse_args(argv)

    report = verify(args.src, args.out, args.wav, args.expect, args.int8, device=args.device)
    if args.json:
        passed = not [r for r in report if r["status"] == "FAIL"]
        print(json.dumps({"report": report, "passed": passed}))
    else:
        passed = print_report(report)
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
