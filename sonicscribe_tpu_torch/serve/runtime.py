"""Runtime construction from CLI specs: model, VAD and engine.

Kept apart from serve/app.py so that a program can drive the engine
without importing aiohttp.
"""

from __future__ import annotations

import torch

from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.device import resolve_device
from sonicscribe_tpu_torch.engine.transcriber import Transcriber
from sonicscribe_tpu_torch.models.config import nano, tiny
from sonicscribe_tpu_torch.models.glm_asr import param_count
from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
from sonicscribe_tpu_torch.models.weights import init_random, load_checkpoint
from sonicscribe_tpu_torch.serve.engine_async import ThreadedEngine
from sonicscribe_tpu_torch.vad.model import EnergyVad


def build_runtime(
    model_spec: str,
    vad_spec: str = "energy",
    config: AppConfig | None = None,
    device=None,
    seed: int = 0,
):
    """-> (engine, vad, model_info).

    model_spec: 'tiny-random' (f32) | 'nano-random' (bf16, full width) | a
    native checkpoint directory. Random weights are drawn from `seed`.
    vad_spec: 'energy'. The engine is the threaded one. `device` as in
    device.resolve_device: the card unless 'cpu' is asked for.
    """
    config = config or AppConfig()
    device = resolve_device(device)
    if config.quant_mode != "native":
        raise NotImplementedError(f"quant mode {config.quant_mode!r} is not yet ported")
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

    transcriber = Transcriber(mcfg, params, tokenizer, prefill_buckets=buckets)
    vad = EnergyVad(device=device)
    engine = ThreadedEngine(transcriber, vad)
    info = {
        "model": model_spec,
        "params": param_count(params),
        "quant_mode": config.quant_mode,
        "vad": vad_spec,
        "engine": "threaded",
        "decode_slots": 1,
        "device": str(device),
        "device_name": (
            torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        ),
        "backend": "torch",
    }
    return engine, vad, info
