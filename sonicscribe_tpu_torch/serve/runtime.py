"""Runtime construction from CLI specs: model, VAD and engine.

Kept apart from serve/app.py so that a program can drive the engine
without importing aiohttp.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.device import resolve_device
from sonicscribe_tpu_torch.engine.batcher import BatchedEngine
from sonicscribe_tpu_torch.engine.transcriber import Transcriber
from sonicscribe_tpu_torch.models.config import nano, tiny
from sonicscribe_tpu_torch.models.glm_asr import param_count
from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
from sonicscribe_tpu_torch.models.weights import init_random, load_checkpoint
from sonicscribe_tpu_torch.ops.quant import quantize_params_int8
from sonicscribe_tpu_torch.serve.engine_async import ThreadedEngine
from sonicscribe_tpu_torch.vad.model import EnergyVad

QUANT_MODES = ("native", "int8", "int8-decoder", "int8-decoder-a8")
ENGINE_KINDS = ("batched", "threaded")


def build_runtime(
    model_spec: str,
    vad_spec: str = "energy",
    config: AppConfig | None = None,
    device=None,
    seed: int = 0,
    engine_kind: str = "batched",
):
    """-> (engine, vad, model_info).

    model_spec: 'tiny-random' (f32) | 'nano-random' (bf16, full width) | a
    native checkpoint directory. Random weights are drawn from `seed`.
    vad_spec: 'energy'. engine_kind: 'batched' (the continuous batcher,
    engine/batcher.py: config.decode_slots long slots, one short slot per
    stream; the default, as in the JAX package) | 'threaded' (one request
    at a time). `device` as in device.resolve_device: the card unless 'cpu'
    is asked for.
    config.quant_mode: 'native' | 'int8' (every projection but embed,
    adapter and lm_head, the reference's skip-list) | 'int8-decoder' (the
    decoder's projections only) | 'int8-decoder-a8' (as int8-decoder, and
    the decode step quantizes its activations per row for the W8A8
    kernel). Quantization runs on `device` after init; the tensors it
    replaced are dropped.
    """
    config = config or AppConfig()
    device = resolve_device(device)
    if config.quant_mode not in QUANT_MODES:
        raise ValueError(f"quant mode {config.quant_mode!r} is not one of {QUANT_MODES}")
    if engine_kind not in ENGINE_KINDS:
        raise ValueError(f"engine {engine_kind!r} is not one of {ENGINE_KINDS}")
    if vad_spec != "energy":
        raise NotImplementedError(f"VAD {vad_spec!r} is not yet ported; use 'energy'")

    if model_spec == "tiny-random":
        mcfg = tiny()
        params = init_random(mcfg, seed, dtype=torch.float32, device=device)
        tokenizer = ByteTokenizer(mcfg)
        buckets = (128, 256)
    elif model_spec == "nano-random":
        mcfg = nano()
        params = init_random(mcfg, seed, dtype=torch.bfloat16, device=device)
        tokenizer = ByteTokenizer(mcfg)
        buckets = tuple(config.prefill_buckets)
    else:
        mcfg, params, tokenizer = load_checkpoint(model_spec, device=device)
        buckets = tuple(config.prefill_buckets)

    if config.quant_mode != "native":
        params = quantize_params_int8(params, decoder_only=config.quant_mode != "int8")
        if config.quant_mode == "int8-decoder-a8":
            mcfg = replace(mcfg, decoder=replace(mcfg.decoder, act_int8_decode=True))

    transcriber = Transcriber(mcfg, params, tokenizer, prefill_buckets=buckets)
    vad = EnergyVad(device=device)
    if engine_kind == "batched":
        engine = BatchedEngine(
            transcriber, vad, slots=config.decode_slots,
            max_decode_tokens=max(config.file_max_new_tokens, config.final_max_tokens))
    else:
        engine = ThreadedEngine(transcriber, vad)
    info = {
        "model": model_spec,
        "params": param_count(params),
        "quant_mode": config.quant_mode,
        "vad": vad_spec,
        "engine": engine_kind,
        "decode_slots": config.decode_slots if engine_kind == "batched" else 1,
        "device": str(device),
        "device_name": (
            torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        ),
        "backend": "torch",
    }
    return engine, vad, info
