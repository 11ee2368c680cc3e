"""The system under test: the port's runtime, built from a configuration.

The port builds its serving runtime with ``serve/runtime.py:build_runtime``
(model, quant mode, VAD, the batched engine with its slots and ring). The
benchmark calls it with ``"nano-random"`` and hands it the benchmark's own
weights (``reference/weights.py``, made on the card from the seed) in
place of the ones that spec would draw, so that the reference can make the
same weights again without reading anything of the program's. It then
warms the engine as the server does at start-up.

``Recorder`` wraps the engine the traffic drives: it passes every call
through and keeps, for each transcription that returned, what the
reference needs to judge it (the call's audio or ring range, its budget
and the tokens served).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@contextlib.contextmanager
def _weights_for_build(runtime_module, params):
    """While building, the runtime's random-weight maker returns `params`.
    Raises if the build never asked for them (a spec that loads or draws
    its weights another way would run on weights the reference never sees)."""
    original = runtime_module.init_random
    asked = []

    def given(mcfg, seed=0, dtype=None, device=None):
        asked.append(True)
        return params

    runtime_module.init_random = given
    try:
        yield
    finally:
        runtime_module.init_random = original
    if not asked:
        raise RuntimeError("the program's build did not take the benchmark's weights")


def app_config(cfg: dict):
    """The serving configuration: the port's AppConfig with the
    configuration's settings (environment variables do not reach it)."""
    from sonicscribe_tpu_torch.config import AppConfig

    serving = cfg["serving"]
    fields = {f.name for f in dataclasses.fields(AppConfig)}
    conf = AppConfig()
    for k, v in serving["app"].items():
        if k not in fields:
            raise ValueError(f"AppConfig has no field {k!r}")
        setattr(conf, k, v)
    conf.quant_mode = cfg["quant_mode"]
    return conf


def build(cfg: dict, family, seed: int, device) -> tuple:
    """-> (engine, vad, conf, info): the runtime with model family
    `family`'s weights from the seed, warmed as the server warms it."""
    from sonicscribe_tpu_torch.serve import runtime

    family.check_widths(cfg, family.program_config(cfg))
    conf = app_config(cfg)
    params = family.make_weights(cfg["model"], seed, device, _DTYPES[cfg["dtype"]])
    with _weights_for_build(runtime, params):
        engine, vad, info = runtime.build_runtime(cfg["spec"], cfg["serving"]["vad"], conf,
                                                  device=device, seed=seed)
    del params
    t0 = time.perf_counter()
    engine.warmup(budgets=(conf.interim_max_new_tokens, conf.final_max_tokens,
                           conf.file_max_new_tokens))
    info["warmup_s"] = time.perf_counter() - t0
    return engine, vad, conf, info


class Recorder:
    """The engine as the traffic sees it, keeping each finished
    transcription: {"path": "file" | "ring", "tokens", "budget", "t"} and
    for the file path "audio" (the call's samples) and "owner" (the
    traffic's tag), for the ring path "stream", "start_chunk" and
    "chunk_count". Failures other than cancellation are counted."""

    def __init__(self, engine, owner=None, sink=None):
        self._engine = engine
        self.owner = owner
        self.sink = sink if sink is not None else {"done": [], "failed": []}

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def tagged(self, owner) -> "Recorder":
        """The same engine and record, with another owner tag."""
        return Recorder(self._engine, owner, self.sink)

    async def transcribe(self, audio, sample_rate, max_new_tokens, **kw):
        try:
            r = await self._engine.transcribe(audio, sample_rate, max_new_tokens, **kw)
        except Exception as e:
            self.sink["failed"].append((time.perf_counter(), repr(e)))
            raise
        self.sink["done"].append({"path": "file", "owner": self.owner, "audio": audio,
                                  "budget": max_new_tokens, "tokens": r.tokens,
                                  "t": time.perf_counter()})
        return r

    async def transcribe_ring(self, stream_idx, start_chunk, chunk_count, max_new_tokens,
                              **kw):
        try:
            r = await self._engine.transcribe_ring(stream_idx, start_chunk, chunk_count,
                                                   max_new_tokens, **kw)
        except Exception as e:
            self.sink["failed"].append((time.perf_counter(), repr(e)))
            raise
        self.sink["done"].append({"path": "ring", "stream": stream_idx,
                                  "start_chunk": start_chunk, "chunk_count": chunk_count,
                                  "budget": max_new_tokens, "tokens": r.tokens,
                                  "t": time.perf_counter()})
        return r
