"""Runtime construction from CLI specs: model, VAD and engine.

Kept apart from serve/app.py so that a program can drive the engine
without importing aiohttp.
"""

from __future__ import annotations

import logging
import os
from dataclasses import replace

import torch

from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.device import resolve_device
from sonicscribe_tpu_torch.engine.batcher import BatchedEngine
from sonicscribe_tpu_torch.engine.replicas import DataParallelEngine
from sonicscribe_tpu_torch.engine.transcriber import Transcriber
from sonicscribe_tpu_torch.models.config import nano, tiny
from sonicscribe_tpu_torch.models.glm_asr import param_count
from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
from sonicscribe_tpu_torch.models.weights import init_random, load_checkpoint
from sonicscribe_tpu_torch.ops.quant import quantize_params_int8
from sonicscribe_tpu_torch.parallel.mesh import make_mesh
from sonicscribe_tpu_torch.serve.engine_async import ThreadedEngine
from sonicscribe_tpu_torch.tools.convert_silero import load_npz
from sonicscribe_tpu_torch.vad.model import EnergyVad, SileroVad

logger = logging.getLogger(__name__)

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
    vad_spec: 'energy' | 'silero' (the weights at config.silero_weights,
    SONIC_SILERO_WEIGHTS; without them it logs the error and serves the
    energy gate, info["vad"] says so) | the path of a converted Silero npz
    (tools/convert_silero.py). engine_kind: 'batched' (the continuous batcher,
    engine/batcher.py: config.decode_slots long slots, one short slot per
    stream; the default, as in the JAX package; config.fuse_dual_decode
    decodes both pools in one program; config.data_parallel > 1: that
    many replicas, one per card, behind engine/replicas.py's router, as
    many as there are cards with a warning where fewer, all on the CPU
    for device 'cpu') | 'threaded' (one request at a time). `device` as in
    device.resolve_device: the card unless 'cpu' is asked for; the first
    replica's card when data-parallel (the replicas take cuda:0 ..
    cuda:dp-1).
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
    vad, vad_served = build_vad(vad_spec, config, device)
    dp = 1
    if engine_kind == "batched":
        engine_kw = dict(
            slots=config.decode_slots,
            max_decode_tokens=max(config.file_max_new_tokens, config.final_max_tokens),
            fuse_dual_decode=config.fuse_dual_decode)
        if config.data_parallel > 1:
            # one replica per card; on the CPU the replicas share it
            n_devices = (config.data_parallel if device.type == "cpu"
                         else torch.cuda.device_count())
            dp = min(config.data_parallel, n_devices)
            if dp < config.data_parallel:
                logger.warning("data_parallel=%d requested but only %d devices; using %d",
                               config.data_parallel, n_devices, dp)
        if dp > 1:
            devices = ([device] * dp if device.type == "cpu"
                       else [torch.device("cuda", i) for i in range(dp)])
            engine = DataParallelEngine(transcriber, vad, make_mesh(devices=devices),
                                        **engine_kw)
        else:
            engine = BatchedEngine(transcriber, vad, **engine_kw)
    else:
        engine = ThreadedEngine(transcriber, vad)
    info = {
        "model": model_spec,
        "params": param_count(params),
        "quant_mode": config.quant_mode,
        "vad": vad_served,
        "engine": engine_kind,
        "decode_slots": config.decode_slots if engine_kind == "batched" else 1,
        "data_parallel": dp,
        "fuse_dual_decode": bool(getattr(engine, "fuse_dual", False)),
        "device": str(device),
        "device_name": (
            torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        ),
        "backend": "torch",
    }
    return engine, vad, info


def build_vad(vad_spec: str, config: AppConfig, device: torch.device):
    """-> (the VAD, what serves: vad_spec, or 'energy (silero weights
    missing)' where 'silero' fell back), with the JAX package's semantics."""
    if vad_spec == "energy":
        return EnergyVad(device=device), vad_spec
    if vad_spec == "silero":
        # A random-init Silero net gates garbage: its speech probabilities
        # are noise, so segments never open or close sensibly. Refuse it and
        # fall back loudly to the energy gate.
        w = config.silero_weights
        if w and os.path.exists(w):
            return SileroVad(params=load_npz(w), device=device), vad_spec
        logger.error(
            "--vad silero without converted weights would serve a RANDOM-INIT net "
            "(garbage gating); falling back to the energy VAD. Convert real Silero "
            "weights with python -m sonicscribe_tpu_torch.tools.convert_silero and "
            "pass their path as --vad or set SONIC_SILERO_WEIGHTS.")
        return EnergyVad(device=device), "energy (silero weights missing)"
    # a converted silero weights file (tools/convert_silero.py)
    return SileroVad(params=load_npz(vad_spec), device=device), vad_spec
