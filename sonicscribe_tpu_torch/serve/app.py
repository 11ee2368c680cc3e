"""aiohttp application: the REST + WebSocket API surface.

Port of the JAX package's ``serve/app.py`` (reference FastAPI app,
backend/main.py:150,171,193,651,701; wire schema SURVEY.md §2.7), on the
engine ``build_runtime`` built: the continuous batcher (``--engine
batched``, the default) or ``ThreadedEngine`` (``--engine threaded``):

    GET  /health            model state, sessions, engine counters, device memory
    GET  /debug/config      derived protocol constants
    GET  /debug/profile     a torch.profiler trace of the next N seconds
    POST /vad/config        runtime VAD reconfiguration, live sessions included
    POST /transcribe/file   multipart upload -> NDJSON stream (or aggregate)
    WS   /ws/audio          64 ms PCM ingest, tentative/committed results
    GET  /, /static         the web UI (frontend/)

This is the only module of the package that imports aiohttp.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import ssl
import time
import uuid
from pathlib import Path
from typing import Optional

import torch
from aiohttp import WSMsgType, web

from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.serve.debug_tap import DebugAudioTap
from sonicscribe_tpu_torch.serve.decode import UnsupportedFormat, decode_audio
from sonicscribe_tpu_torch.serve.files import FileTranscriptionConfig, transcribe_file_stream
from sonicscribe_tpu_torch.serve.runtime import build_runtime
from sonicscribe_tpu_torch.serve.session import StreamSession

logger = logging.getLogger(__name__)

RECEIVE_TIMEOUT_S = 5.0  # reference main.py:782
INACTIVITY_DISCONNECT_S = 30.0  # reference main.py:790-800
MAX_UPLOAD_BYTES = 100 * 1024 * 1024  # reference FileAnalyzer.js:632
RESUME_WINDOW_S = 60.0  # detached sessions stay resumable this long
FRONTEND_DIR = Path(__file__).resolve().parents[2] / "frontend"


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
    # a crashed scheduler (the stall watchdog's abort on a wedged card)
    # reports degraded, so that a supervisor's liveness probe restarts it
    alive = getattr(engine, "alive", True)
    return web.json_response(
        {
            "status": "ok" if engine and alive else "degraded" if engine else "initializing",
            "model_loaded": engine is not None,
            "vad_loaded": app.get("vad") is not None,
            "model_info": app.get("model_info", {}),
            "active_sessions": len(app["sessions"]),
            "engine_stats": {
                k: v
                for k, v in getattr(engine, "stats", {}).items()
                if isinstance(v, (int, float, str))
            },
            "device_memory": _device_memory(),
            "config": app["config"].protocol_constants(),
        }
    )


async def debug_profile(request: web.Request) -> web.Response:
    """A torch.profiler trace (host ops, and the card's kernels where one is
    in use) of the next `seconds` (at most 30), written as a Chrome trace
    into `dir` (default ./profile_traces). Fetch with
    curl 'http://host/debug/profile?seconds=3', open in Perfetto."""
    from torch.profiler import ProfilerActivity, profile

    seconds = min(float(request.query.get("seconds", "3")), 30.0)
    trace_dir = request.query.get("dir", os.path.join(os.getcwd(), "profile_traces"))
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        await asyncio.sleep(seconds)
    path = os.path.join(trace_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return web.json_response({"trace_dir": trace_dir, "trace": path, "seconds": seconds})


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
            # the engine build_runtime built, as its model info says
            "engine": request.app["model_info"].get("engine"),
            "decode_slots": request.app["model_info"].get("decode_slots"),
        }
    )


async def vad_config(request: web.Request) -> web.Response:
    """Runtime VAD reconfiguration (reference main.py:651-668), applied to
    the server's config and to every live session."""
    cfg: AppConfig = request.app["config"]
    try:
        body = await request.json()
        threshold = float(body["threshold"]) if "threshold" in body else None
        window = int(body["smoothing_window"]) if "smoothing_window" in body else None
    except (ValueError, TypeError):
        raise web.HTTPBadRequest(text=json.dumps({"error": "invalid JSON body"}))
    if threshold is not None and not 0.05 <= threshold <= 0.95:
        raise web.HTTPBadRequest(text=json.dumps({"error": "threshold must be in [0.05, 0.95]"}))
    if window is not None and not 1 <= window <= 10:
        raise web.HTTPBadRequest(text=json.dumps({"error": "smoothing_window must be in [1, 10]"}))
    updated = {}
    if threshold is not None:
        cfg.vad_speech_threshold = updated["threshold"] = threshold
    if window is not None:
        cfg.vad_smoothing_window = updated["smoothing_window"] = window
    # scoped to this server's sessions, unlike the reference's global class
    # mutation (main.py:658), with the same effect on open streams
    for session in request.app["sessions"].values():
        if "smoothing_window" in updated:
            session.gate.cfg.smoothing_window = updated["smoothing_window"]
        if "threshold" in updated:
            t = updated["threshold"]
            session.gate.cfg.base_threshold = t
            if session.gate.is_speaking:
                # mid-speech: never lower the dynamic threshold below base
                session.gate.threshold = max(session.gate.threshold, t)
            else:
                session.gate.threshold = t
    return web.json_response({"status": "updated", "config": updated})


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
        # resampled on the (first) engine's card, returned to the host: each
        # segment then goes to whichever replica serves it, which uploads it
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


# ---------------------------------------------------------------------
# WebSocket
# ---------------------------------------------------------------------


def _repair_frames(data: bytes, chunk_size: int) -> list[bytes]:
    """Split oversized / zero-pad undersized frames to exactly `chunk_size`
    (reference main.py:813-838)."""
    frames = []
    for off in range(0, len(data), chunk_size):
        piece = data[off : off + chunk_size]
        if len(piece) < chunk_size:
            piece = piece + b"\x00" * (chunk_size - len(piece))
        frames.append(piece)
    return frames or [b"\x00" * chunk_size]


def _sweep_detached(app) -> None:
    """Clean up the detached sessions whose resume window has passed."""
    window = app.get("resume_window_s", RESUME_WINDOW_S)
    now = time.monotonic()
    cleanups = app["sweeper"].setdefault("cleanups", set())  # awaited at shutdown
    for cid in [c for c, (t, _) in app["detached"].items() if now - t > window]:
        _, sess = app["detached"].pop(cid)
        task = asyncio.ensure_future(sess.cleanup())
        cleanups.add(task)
        task.add_done_callback(cleanups.discard)


async def _periodic_sweep(app) -> None:
    """Expire detached sessions on a timer, not only on new WS connects, so
    that a disconnect with no later traffic still releases its session.
    Interval = window / 4 keeps the worst-case overstay under 1.25x."""
    window = app.get("resume_window_s", RESUME_WINDOW_S)
    while True:
        await asyncio.sleep(max(0.05, window / 4))
        _sweep_detached(app)


async def _start_sweeper(app) -> None:
    # inner-dict mutation: aiohttp deprecates app[...] writes after startup
    app["sweeper"]["task"] = asyncio.ensure_future(_periodic_sweep(app))


async def _stop_sweeper(app) -> None:
    task = app["sweeper"].pop("task", None)
    if task is not None:
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
    cleanups = app["sweeper"].pop("cleanups", set())
    if cleanups:
        await asyncio.gather(*cleanups, return_exceptions=True)


async def ws_audio(request: web.Request) -> web.WebSocketResponse:
    app = request.app
    cfg: AppConfig = app["config"]
    ws = web.WebSocketResponse(heartbeat=None)
    await ws.prepare(request)

    async def send_json(msg: dict) -> None:
        if not ws.closed:
            await ws.send_str(json.dumps(msg, ensure_ascii=False))

    # ?resume=<client_id> re-attaches a recently disconnected session's
    # buffer, gate and hotwords (the reference always started afresh)
    _sweep_detached(app)
    resume_id = request.query.get("resume", "")
    resumed = False
    if resume_id and resume_id in app["detached"]:
        _, session = app["detached"].pop(resume_id)
        client_id = resume_id
        session.send = send_json
        session.active = True
        resumed = True
    else:
        client_id = uuid.uuid4().hex[:12]
        session = StreamSession(client_id, cfg, app["engine"], send_json)
    app["sessions"][client_id] = session
    logger.info("[%s] ws connected%s", client_id, " (resumed)" if resumed else "")

    tap = None
    if cfg.debug_audio_enabled:
        tap = DebugAudioTap(cfg.debug_audio_base_dir, client_id, cfg.audio_sample_rate)
        await send_json({"type": "debug_audio_info", "enabled": True, "path": tap.path})

    await send_json(
        {
            "type": "connection_established",
            "client_id": client_id,
            "resumed": resumed,
            "config": cfg.protocol_constants(),
            "capabilities": [
                "tentative_output", "committed_output", "hotwords",
                "vad_config", "resume",
            ],
        }
    )

    last_activity = time.monotonic()
    explicit_close = False
    try:
        while not ws.closed:
            try:
                msg = await ws.receive(timeout=RECEIVE_TIMEOUT_S)
            except asyncio.TimeoutError:
                if time.monotonic() - last_activity > INACTIVITY_DISCONNECT_S:
                    await send_json(
                        {"type": "error", "code": "inactivity_timeout",
                         "message": "no audio for 30s, closing"}
                    )
                    explicit_close = True
                    break
                continue

            if msg.type == WSMsgType.BINARY:
                last_activity = time.monotonic()
                if tap is not None:
                    tap.write(msg.data)
                for frame in _repair_frames(msg.data, cfg.audio_chunk_size):
                    await session.on_audio(frame)
            elif msg.type == WSMsgType.TEXT:
                last_activity = time.monotonic()
                try:
                    ctrl = json.loads(msg.data)
                except json.JSONDecodeError:
                    await send_json(
                        {"type": "error", "code": "bad_json",
                         "message": "unparseable control message"}
                    )
                    continue
                await _handle_control(ctrl, session, send_json)
                if ctrl.get("type") == "close":
                    explicit_close = True
                    break
            elif msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING, WSMsgType.CLOSED,
                              WSMsgType.ERROR):
                break
    finally:
        app["sessions"].pop(client_id, None)
        if tap is not None:
            tap.close()
        if explicit_close:
            try:
                await asyncio.wait_for(session.flush(), timeout=10.0)
            except Exception:
                logger.exception("[%s] flush on close failed", client_id)
            await session.cleanup()
        else:
            # abnormal disconnect: park the session for a resume
            session.active = False
            app["detached"][client_id] = (time.monotonic(), session)
        if not ws.closed:
            await ws.close()
        logger.info("[%s] ws closed%s", client_id, "" if explicit_close else " (resumable)")
    return ws


async def _handle_control(ctrl: dict, session: StreamSession, send_json) -> None:
    """Dispatch WS control messages (reference main.py:841-917)."""
    mtype = ctrl.get("type")
    if mtype == "ping":
        await send_json({"type": "pong", "t": time.time()})
    elif mtype == "get_state":
        await send_json(session.state_snapshot())
    elif mtype == "vad_config":
        if "vad_enabled" in ctrl:
            session.vad_enabled = bool(ctrl["vad_enabled"])
        if "threshold" in ctrl:
            t = float(ctrl["threshold"])
            if 0.05 <= t <= 0.95:
                session.gate.cfg.base_threshold = t
                session.gate.threshold = max(session.gate.threshold, t)
        await send_json(
            {"type": "config_updated",
             "vad_enabled": session.vad_enabled,
             "threshold": session.gate.cfg.base_threshold}
        )
    elif mtype == "hotwords_config":
        words = ctrl.get("hotwords", [])
        if not isinstance(words, list):
            await send_json({"type": "error", "code": "bad_hotwords",
                             "message": "hotwords must be a list"})
            return
        session.hotwords = [str(w).strip() for w in words if str(w).strip()][:10]
        await send_json({"type": "hotwords_updated", "hotwords": session.hotwords})
    elif mtype != "close":  # close: handled by the caller
        await send_json({"type": "error", "code": "unknown_message",
                         "message": f"unknown control type: {mtype!r}"})


def build_app(config: AppConfig, engine, vad, model_info: dict | None = None) -> web.Application:
    app = web.Application(middlewares=[cors_middleware], client_max_size=MAX_UPLOAD_BYTES + 1024)
    app["config"] = config
    app["engine"] = engine
    app["vad"] = vad
    app["model_info"] = model_info or {}
    app["sessions"] = {}
    app["detached"] = {}  # client_id -> (detach time, session), resumable
    app["sweeper"] = {}  # the periodic sweep task once started, and its cleanups
    app.on_startup.append(_start_sweeper)
    app.on_cleanup.append(_stop_sweeper)
    app.router.add_get("/health", health)
    app.router.add_get("/debug/config", debug_config)
    app.router.add_get("/debug/profile", debug_profile)
    app.router.add_post("/vad/config", vad_config)
    app.router.add_post("/transcribe/file", transcribe_file)
    app.router.add_get("/ws/audio", ws_audio)

    # the web UI: vanilla ES modules, no build step
    if FRONTEND_DIR.is_dir():
        index_path = FRONTEND_DIR / "index.html"

        async def index(_request):
            return web.FileResponse(index_path)

        app.router.add_get("/", index)
        app.router.add_static("/static", FRONTEND_DIR)
    return app


def main(argv=None):
    parser = argparse.ArgumentParser(description="SonicScribe server (PyTorch/CUDA port)")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--model", default=None,
                        help="'tiny-random' | 'nano-random' | native checkpoint dir "
                             "(default: $CHECKPOINT_PATH if that directory exists, else "
                             "tiny-random)")
    parser.add_argument(
        "--vad", default="energy",
        help="'energy' | 'silero' (weights from SONIC_SILERO_WEIGHTS; without them "
             "the energy gate serves) | path to a converted silero .npz "
             "(python -m sonicscribe_tpu_torch.tools.convert_silero)")
    parser.add_argument(
        "--quant", default=None,
        help="'native' | 'int8' | 'int8-decoder' | 'int8-decoder-a8' (a8: decode "
             "activations quantized per row, s8 x s8 kernel); default $QUANT_MODE "
             "or native",
    )
    parser.add_argument("--device", default=None,
                        help="'cuda' (default; fails without a card) | 'cpu'")
    parser.add_argument("--engine", default="batched", choices=("batched", "threaded"),
                        help="continuous batcher (default) or one request at a time")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip the startup capture of the CUDA graphs: the first "
                             "use of each program key captures its own")
    parser.add_argument("--warmup-full", action="store_true",
                        help="batched engine: capture every batch size of each pool's "
                             "prefill programs, not only the serving grid")
    parser.add_argument("--warmup-fast", action="store_true",
                        help="batched engine: two-phase boot; block only on the programs "
                             "serving starts with, and capture the rest (group prefills, "
                             "rows variants, long escalation rungs, the verify grid) in "
                             "idle ticks; /health shows warmup_background_pending")
    args = parser.parse_args(argv)
    if args.warmup_full and args.warmup_fast:
        parser.error("--warmup-full and --warmup-fast are mutually exclusive")

    config = AppConfig()
    if args.host:
        config.host = args.host
    if args.port:
        config.port = args.port
    if args.quant:
        config.quant_mode = args.quant
    if args.model is None:
        args.model = (config.checkpoint_path if os.path.isdir(config.checkpoint_path)
                      else "tiny-random")
    logging.basicConfig(
        level=getattr(logging, config.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    engine, vad, info = build_runtime(args.model, args.vad, config, device=args.device,
                                      engine_kind=args.engine)
    modes = {}
    if args.engine == "batched":
        modes = {"full": True} if args.warmup_full else {"fast": True} if args.warmup_fast else {}
    elif args.warmup_full or args.warmup_fast:
        logger.warning("--warmup-full / --warmup-fast apply to --engine batched only; ignored")
    if not args.no_warmup:
        t0 = time.perf_counter()
        # the JAX app's grid: each budget's ceiling serves every budget below it
        engine.warmup(budgets=(config.interim_max_new_tokens, config.final_max_tokens,
                               config.file_max_new_tokens), **modes)
        # the blocking phase (a fast boot's deferred captures come later)
        info["warmup_s"] = round(time.perf_counter() - t0, 1)
    logger.info("runtime ready: %s", info)
    ssl_ctx = None
    if config.use_https and config.ssl_certfile:
        ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ssl_ctx.load_cert_chain(config.ssl_certfile, config.ssl_keyfile or None)
    web.run_app(build_app(config, engine, vad, info), host=config.host, port=config.port,
                ssl_context=ssl_ctx)
