"""The plain reference agrees with the port at tiny() in float32 on the CPU."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from gpubench import manifest
from gpubench.reference import check, frontend, model, quant
from gpubench.reference.weights import QUANT_LEAVES, make_weights
from gpubench.tests.tiny import tiny_config
from gpubench.traffic import synth

GLM_ASR = manifest.family("glm_asr")


def _port(cfg: dict, seed: int):
    from sonicscribe_tpu_torch.engine.transcriber import Transcriber
    from sonicscribe_tpu_torch.models.config import tiny
    from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer

    mcfg = tiny()
    params = make_weights(cfg["model"], seed, "cpu", torch.float32)
    return Transcriber(mcfg, params, ByteTokenizer(mcfg), prefill_buckets=(128, 256))


@pytest.mark.parametrize("seconds", [0.55, 1.3, 2.5])
def test_reference_logits_and_tokens_equal_the_ports(seconds):
    from sonicscribe_tpu_torch.audio.mel import log_mel_spectrogram
    from sonicscribe_tpu_torch.models.glm_asr import encode_audio, prefill_kv
    from sonicscribe_tpu_torch.models.tokenizer import build_prompt

    cfg, seed = tiny_config(), 2**31 + 99
    tr = _port(cfg, seed)
    pcm = synth.to_pcm16(synth.speech_tape(np.random.default_rng(5), seconds))
    audio = pcm.astype(np.float32) / 32768.0
    result = tr.transcribe(audio, 16000, max_new_tokens=24)
    toks = [int(t) for t in result.tokens]
    assert len(toks) >= 1

    W = GLM_ASR.reference_weights(cfg, seed, "cpu")
    prefix, suffix = check.prompt_ids(cfg)
    prompt = build_prompt(tr.tokenizer, tr.cfg)
    assert prefix == list(prompt.prefix_ids) and suffix == list(prompt.suffix_ids)
    mel = frontend.file_mel(torch.from_numpy(audio), cfg["frontend"])
    x = torch.from_numpy(audio)
    x = x / x.abs().max()
    port_mel = log_mel_spectrogram(x, tr.mel_cfg, pad_to_frames=256)
    frames = mel.shape[0]
    assert torch.allclose(mel, port_mel[:frames], atol=2e-4)

    ref = model.served_logits(W, cfg["model"], mel, prefix, suffix, toks)
    assert ref.argmax(dim=1).tolist() == toks

    # the first token's logits against the port's prefill of the same prompt
    embeds, n_tok = encode_audio(tr.params, tr.cfg, port_mel[None], torch.tensor([frames]))
    emb = tr.params["decoder"]["embed"]
    seq = torch.cat([emb[torch.tensor(prefix)], embeds[0, : int(n_tok[0])],
                     emb[torch.tensor(suffix)]])[None]
    _, _, logits = prefill_kv(tr.params, tr.cfg, seq, torch.tensor([seq.shape[1]]))
    assert torch.allclose(ref[0], logits[0], atol=1e-3, rtol=1e-3)


def test_ring_mel_is_the_ports_batched_mel():
    from sonicscribe_tpu_torch.audio.mel import MelConfig, log_mel_batch

    cfg = tiny_config()
    pcm = synth.to_pcm16(synth.speech_tape(np.random.default_rng(8), 1.0))[: 13 * 1024]
    x = torch.from_numpy(pcm.astype(np.float32) / 32768.0)
    bucket = frontend.chunk_bucket(13, [128, 256], 1024, 160) * 1024
    ours = frontend.ring_mel(x, bucket, cfg["frontend"])
    padded = torch.nn.functional.pad(x / x.abs().max(), (0, bucket - len(x)))[None]
    theirs, n = log_mel_batch(padded, torch.tensor([len(x)]), MelConfig())
    assert int(n[0]) == ours.shape[0]
    assert torch.allclose(ours, theirs[0, : ours.shape[0]], atol=2e-4)


def test_int8_recipe_is_the_ports():
    from sonicscribe_tpu_torch.ops.quant import dequantize_tensor, quantize_tensor

    w = torch.randn(3, 64, 48, generator=torch.Generator().manual_seed(1)) * 0.02
    assert torch.equal(quant.fake_quant(w, 8), dequantize_tensor(quantize_tensor(w)))


def test_the_control_reads_far_above_the_program():
    """The bf16 cells' control (the reference on int8 codes) kept at a size a
    test holds: nano's widths, two encoder and two decoder layers, float32
    on the CPU. The program's widest gap there is nought; the control's is
    not, and int4 codes (the int8 cell's control) read far above it."""
    from dataclasses import replace

    from sonicscribe_tpu_torch.engine.transcriber import Transcriber
    from sonicscribe_tpu_torch.models.config import nano
    from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer

    cfg = copy.deepcopy(manifest.cell("nano-bf16.files-novad").config)
    cfg["dtype"] = "float32"
    cfg["model"]["encoder"]["n_layers"] = cfg["model"]["decoder"]["n_layers"] = 2
    mcfg = nano()
    mcfg = replace(mcfg, encoder=replace(mcfg.encoder, n_layers=2),
                   decoder=replace(mcfg.decoder, n_layers=2))
    seed = 2**31 + 3
    tr = Transcriber(mcfg, make_weights(cfg["model"], seed, "cpu", torch.float32),
                     ByteTokenizer(mcfg), prefill_buckets=(128, 256))
    reqs = []
    for i, seconds in enumerate((0.9, 1.7, 2.4)):
        pcm = synth.to_pcm16(synth.speech_tape(np.random.default_rng(20 + i), seconds))
        toks = tr.transcribe(pcm.astype(np.float32) / 32768.0, 16000, max_new_tokens=48).tokens
        reqs.append({"path": "file", "pcm": pcm, "tokens": list(toks)})
    int8 = check.gaps(GLM_ASR, cfg, seed, reqs, "cpu", control=True)
    assert int8["gap_max"] == 0.0 and int8["tokens"] == 144
    assert int8["control"]["gap_max"] > 0.01
    cfg8 = dict(cfg, weight_bits=8, quantized_leaves=list(QUANT_LEAVES))
    assert check.control_bits(cfg8) == 4
    int4 = check.gaps(GLM_ASR, cfg8, seed, reqs, "cpu", control=True)
    assert int4["control"]["gap_max"] > 10 * int8["control"]["gap_max"]
