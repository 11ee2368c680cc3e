"""aiohttp application: the file-transcription API surface.

Port of the JAX package's ``serve/app.py`` for the file path (reference
FastAPI app, backend/main.py:150,171,193; wire schema SURVEY.md §2.7):

    GET  /health            model state, engine counters, device memory
    GET  /debug/config      derived protocol constants
    POST /transcribe/file   multipart upload -> NDJSON stream (or aggregate)

``/ws/audio``, ``/vad/config`` and ``/debug/profile`` come with the
streaming slice. This is the only module of the package that imports
aiohttp.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import time
from typing import Optional

import torch
from aiohttp import web

from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.serve.decode import UnsupportedFormat, decode_audio
from sonicscribe_tpu_torch.serve.files import FileTranscriptionConfig, transcribe_file_stream
from sonicscribe_tpu_torch.serve.runtime import build_runtime

logger = logging.getLogger(__name__)

MAX_UPLOAD_BYTES = 100 * 1024 * 1024  # reference FileAnalyzer.js:632


@web.middleware
async def cors_middleware(request: web.Request, handler):
    if request.method == "OPTIONS":
        resp = web.Response()
    else:
        try:
            resp = await handler(request)
        except web.HTTPException as e:
            resp = e
    resp.headers["Access-Control-Allow-Origin"] = "*"
    resp.headers["Access-Control-Allow-Methods"] = "GET, POST, OPTIONS"
    resp.headers["Access-Control-Allow-Headers"] = "*"
    if isinstance(resp, web.HTTPException):
        raise resp
    return resp


def _device_memory() -> dict:
    """The card's allocator statistics (torch.cuda.memory_stats); empty
    when no card is in use."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    stats = torch.cuda.memory_stats()
    out = {}
    for key, name in (
        ("allocated_bytes.all.current", "bytes_in_use"),
        ("allocated_bytes.all.peak", "peak_bytes_in_use"),
        ("reserved_bytes.all.current", "bytes_reserved"),
    ):
        if key in stats:
            out[name + "_mb"] = round(stats[key] / (1024 * 1024), 1)
    return out


async def health(request: web.Request) -> web.Response:
    app = request.app
    engine = app.get("engine")
    return web.json_response(
        {
            "status": "ok" if engine else "initializing",
            "model_loaded": engine is not None,
            "vad_loaded": app.get("vad") is not None,
            "model_info": app.get("model_info", {}),
            "active_sessions": 0,
            "engine_stats": {
                k: v
                for k, v in getattr(engine, "stats", {}).items()
                if isinstance(v, (int, float, str))
            },
            "device_memory": _device_memory(),
            "config": app["config"].protocol_constants(),
        }
    )


async def debug_config(request: web.Request) -> web.Response:
    cfg: AppConfig = request.app["config"]
    return web.json_response(
        {
            **cfg.protocol_constants(),
            "vad_speech_threshold": cfg.vad_speech_threshold,
            "vad_smoothing_window": cfg.vad_smoothing_window,
            "decode_budgets": {
                "interim": cfg.interim_max_new_tokens,
                "final_max": cfg.final_max_tokens,
                "file": cfg.file_max_new_tokens,
            },
            "quant_mode": cfg.quant_mode,
        }
    )


async def transcribe_file(request: web.Request) -> web.StreamResponse:
    """Multipart upload -> NDJSON stream (reference main.py:193-523)."""
    app = request.app
    engine = app.get("engine")
    if engine is None:
        raise web.HTTPServiceUnavailable(
            text=json.dumps({"error": "model not loaded"})
        )

    stream_mode = request.query.get("stream", "true").lower() != "false"
    file_bytes: Optional[bytes] = None
    filename = ""
    config_str = "{}"

    if not (request.content_type or "").startswith("multipart/"):
        raise web.HTTPBadRequest(
            text=json.dumps({"error": "expected multipart/form-data with a 'file' field"})
        )
    reader = await request.multipart()
    async for part in reader:
        if part.name == "file":
            filename = part.filename or ""
            file_bytes = await part.read(decode=False)
            if len(file_bytes) > MAX_UPLOAD_BYTES:
                raise web.HTTPRequestEntityTooLarge(
                    max_size=MAX_UPLOAD_BYTES, actual_size=len(file_bytes)
                )
        elif part.name == "config_str":
            config_str = (await part.read(decode=False)).decode("utf-8", "replace")

    if not file_bytes:
        raise web.HTTPBadRequest(text=json.dumps({"error": "missing 'file' field"}))

    try:
        file_cfg = FileTranscriptionConfig.from_dict(
            json.loads(config_str or "{}"),
            default_threshold=app["config"].vad_speech_threshold,
        )
    except (json.JSONDecodeError, ValueError, TypeError) as e:
        raise web.HTTPBadRequest(
            text=json.dumps({"error": f"bad config_str: {e}"})
        )
    file_cfg.max_new_tokens = app["config"].file_max_new_tokens
    file_cfg.concurrency = getattr(engine, "concurrency_hint", 3)

    try:
        loop = asyncio.get_running_loop()
        audio = await loop.run_in_executor(
            None, decode_audio, file_bytes, filename, engine.transcriber.device
        )
    except UnsupportedFormat as e:
        raise web.HTTPUnsupportedMediaType(text=json.dumps({"error": str(e)}))
    except Exception as e:
        raise web.HTTPBadRequest(text=json.dumps({"error": f"decode failed: {e}"}))

    gen = transcribe_file_stream(audio, engine, app.get("vad"), file_cfg, filename)

    if stream_mode:
        resp = web.StreamResponse(
            status=200,
            headers={
                "Content-Type": "application/x-ndjson",
                "Access-Control-Allow-Origin": "*",
            },
        )
        await resp.prepare(request)
        async for msg in gen:
            await resp.write((json.dumps(msg, ensure_ascii=False) + "\n").encode())
        await resp.write_eof()
        return resp

    # aggregate mode (reference main.py:497-516)
    messages = [msg async for msg in gen]
    summary = messages[-1] if messages else {}
    return web.json_response(
        {
            "segments": [m for m in messages if m.get("type") == "segment_result"],
            "errors": [m for m in messages if m.get("type") == "segment_error"],
            "summary": summary,
        }
    )


def build_app(config: AppConfig, engine, vad, model_info: dict | None = None) -> web.Application:
    app = web.Application(middlewares=[cors_middleware], client_max_size=MAX_UPLOAD_BYTES + 1024)
    app["config"] = config
    app["engine"] = engine
    app["vad"] = vad
    app["model_info"] = model_info or {}
    app.router.add_get("/health", health)
    app.router.add_get("/debug/config", debug_config)
    app.router.add_post("/transcribe/file", transcribe_file)
    return app


def main(argv=None):
    parser = argparse.ArgumentParser(description="SonicScribe server (PyTorch/CUDA port)")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--model", default="tiny-random",
                        help="'tiny-random' | 'nano-random' | native checkpoint dir")
    parser.add_argument("--vad", default="energy", help="'energy'")
    parser.add_argument(
        "--quant", default=None,
        help="'native' | 'int8' | 'int8-decoder' | 'int8-decoder-a8' (a8: decode "
             "activations quantized per row, s8 x s8 kernel); default $QUANT_MODE "
             "or native",
    )
    parser.add_argument("--device", default=None,
                        help="'cuda' (default; fails without a card) | 'cpu'")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip the startup capture of the CUDA graphs: the first "
                             "request of each (bucket, budget) captures its own")
    args = parser.parse_args(argv)

    config = AppConfig()
    if args.host:
        config.host = args.host
    if args.port:
        config.port = args.port
    if args.quant:
        config.quant_mode = args.quant
    logging.basicConfig(
        level=getattr(logging, config.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    engine, vad, info = build_runtime(args.model, args.vad, config, device=args.device)
    if not args.no_warmup:
        t0 = time.perf_counter()
        # the JAX app's grid less the streaming final budget (not ported yet)
        engine.warmup(budgets=(config.interim_max_new_tokens, config.file_max_new_tokens))
        info["warmup_s"] = round(time.perf_counter() - t0, 1)
    logger.info("runtime ready: %s", info)
    web.run_app(build_app(config, engine, vad, info), host=config.host, port=config.port)
