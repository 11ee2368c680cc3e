"""CLI transcription: one audio file -> NDJSON on stdout, no server.

Counterpart of the JAX package's ``transcribe.py`` (the reference's
``asr.py`` __main__ harness, backend/asr.py:517-558):

    python -m sonicscribe_tpu_torch.transcribe audio.wav --model nano-random
    python -m sonicscribe_tpu_torch.transcribe audio.wav --hotwords gpu,cuda --vad
    python -m sonicscribe_tpu_torch.transcribe audio.wav --model tiny-random --device cpu

The messages are those of ``POST /transcribe/file?stream=true``
(``serve/files.py:transcribe_file_stream``), one JSON object per line.
It runs the batched engine, as the JAX CLI and the server do: a file's
segments decode side by side on its slots. Without a warmup, each program
key is captured on its first use.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

from sonicscribe_tpu_torch.serve.runtime import QUANT_MODES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="SonicScribe file transcription (PyTorch/CUDA port)")
    ap.add_argument("audio", help="path to an audio file (WAV preferred)")
    ap.add_argument("--model", default="tiny-random",
                    help="'tiny-random' | 'nano-random' | native checkpoint dir")
    ap.add_argument("--quant", default="native", choices=QUANT_MODES)
    ap.add_argument("--vad", action="store_true", help="VAD-segment the file")
    ap.add_argument("--hotwords", default="", help="comma-separated, max 10")
    ap.add_argument("--max-new-tokens", type=int, default=256)
    ap.add_argument("--info", action="store_true",
                    help="print model info (get_model_info parity) and exit")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default; fails without a card) | 'cpu'")
    args = ap.parse_args(argv)

    from sonicscribe_tpu_torch.config import AppConfig
    from sonicscribe_tpu_torch.serve.decode import decode_audio
    from sonicscribe_tpu_torch.serve.files import FileTranscriptionConfig, transcribe_file_stream
    from sonicscribe_tpu_torch.serve.runtime import build_runtime

    config = AppConfig()
    config.quant_mode = args.quant
    engine, vad, info = build_runtime(args.model, "energy", config, device=args.device,
                                      engine_kind="batched")
    try:
        if args.info:
            print(json.dumps(info))
            return 0
        with open(args.audio, "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        audio = decode_audio(data, args.audio, engine.transcriber.device)
        file_cfg = FileTranscriptionConfig(
            vad_enabled=args.vad,
            hotwords=[w.strip() for w in args.hotwords.split(",") if w.strip()][:10],
            max_new_tokens=args.max_new_tokens,
        )

        async def run():
            async for msg in transcribe_file_stream(
                audio, engine, vad if args.vad else None, file_cfg, args.audio
            ):
                print(json.dumps(msg, ensure_ascii=False), flush=True)

        asyncio.run(run())
        print(f"# total {time.perf_counter() - t0:.2f}s", file=sys.stderr)
        return 0
    finally:
        engine.shutdown()


if __name__ == "__main__":
    sys.exit(main())
