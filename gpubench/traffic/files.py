"""Uploaded files in a closed loop: the generator of the "files" kind.

Each of ``clients`` clients uploads WAV files one after another, the next
once the last one's ``final_summary`` has come, through the file path the
server's ``POST /transcribe/file`` runs (without HTTP): ``decode_audio``
on an executor thread, then ``transcribe_file_stream`` with the server's
file settings (its VAD threshold, ``file_max_new_tokens``, the engine's
``concurrency_hint``) and the mix's request options (``config_str``). A
file is pauses and utterances, its length, each utterance's and each
pause's drawn as the mix says (``synth.Draws``).

Mix parameters: clients, file_s [lo, hi] (uniform), utterance_s {median,
sigma, lo, hi}, pause_s [lo, hi], request (the upload's config_str),
tape_s, start_stagger_s (client i starts i / clients of it late),
settle_s.

The window opens ``settle_s`` after the first upload; a traced run traces
the load that goes on right after it. What it counts: the transcriptions
the engine returned inside it (their audio seconds) and the failures;
each file's plan (``segments_summary``) is kept to locate a sampled
segment's audio in it.
"""

from __future__ import annotations

import asyncio

import numpy as np

from gpubench.traffic import synth

KIND = "files"


class _Client:
    def __init__(self, i: int, seed: int, mix: dict, tape: np.ndarray, hush: np.ndarray):
        self.i = i
        self.mix = mix
        self.tape = tape
        self.hush = hush
        self.draws = synth.Draws(np.random.default_rng([seed, 2, i]))
        self.k = 0

    def _pause(self, seconds: float) -> np.ndarray:
        n = int(seconds * synth.SR)
        at = int(self.draws.next_u("offset") * (len(self.hush) - n))
        return self.hush[at : at + n]

    def next_file(self) -> np.ndarray:
        """The next file's int16 samples: pause, utterance, ... , pause, cut
        (or padded with a pause) to its drawn length."""
        m = self.mix
        total = self.draws.uniform("file", *m["file_s"])
        u = m["utterance_s"]
        parts, t = [], 0.0
        while True:
            p = self.draws.uniform("pause", *m["pause_s"])
            parts.append(self._pause(p))
            t += p
            if t >= total:
                break
            d = min(self.draws.lognormal("utterance", u["median"], u["sigma"], u["lo"], u["hi"]),
                    max(total - t, u["lo"]))
            parts.append(synth.take(self.tape, self.draws, d))
            t += d
        self.k += 1
        x = np.concatenate(parts)[: int(total * synth.SR)]
        return synth.to_pcm16(np.concatenate([x, self._pause(total - len(x) / synth.SR)]))


async def run(ctx) -> dict:
    from sonicscribe_tpu_torch.serve.decode import decode_audio
    from sonicscribe_tpu_torch.serve.files import FileTranscriptionConfig, transcribe_file_stream

    mix, conf, engine = ctx.mix, ctx.conf, ctx.engine
    rng = np.random.default_rng([ctx.seed, 1])
    tape = synth.speech_tape(rng, mix["tape_s"])
    hush = synth.noise(rng, 2 * mix["pause_s"][1] + 1.0)
    clients = [_Client(i, ctx.seed, mix, tape, hush) for i in range(mix["clients"])]
    fcfg = FileTranscriptionConfig.from_dict(mix["request"],
                                             default_threshold=conf.vad_speech_threshold)
    fcfg.max_new_tokens = conf.file_max_new_tokens
    fcfg.concurrency = getattr(engine, "concurrency_hint", 3)
    device = engine.transcriber.device
    loop = asyncio.get_running_loop()
    files: dict = {}  # (client, k) -> {"pcm", "plan"}
    stop = asyncio.Event()

    async def client(c: _Client):
        await asyncio.sleep(c.i * mix["start_stagger_s"] / max(1, mix["clients"]))
        while not stop.is_set():
            pcm = c.next_file()
            key = (c.i, c.k)
            name = f"client{c.i}-{c.k}.wav"
            rec = {"pcm": pcm, "plan": []}
            files[key] = rec
            with ctx.spans.span("client.decode_audio"):
                audio = await loop.run_in_executor(None, decode_audio, synth.wav_bytes(pcm),
                                                   name, device)
            with ctx.spans.span("pipeline.file"):
                async for msg in transcribe_file_stream(audio, engine.tagged(key), ctx.vad,
                                                        fcfg, name):
                    if msg["type"] == "segments_summary":
                        rec["plan"] = [(s["start_time"], s["duration"]) for s in msg["segments"]]

    tasks = [asyncio.ensure_future(client(c)) for c in clients]
    try:
        await asyncio.sleep(mix["settle_s"])
        ctx.open_window()
        await asyncio.sleep(ctx.seconds)
        ctx.close_window()
        await ctx.trace_after()
    finally:
        stop.set()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    t0, t1 = ctx.t0, ctx.t1
    done = [r for r in engine.sink["done"] if t0 <= r["t"] <= t1]
    failed = [f for f in engine.sink["failed"] if t0 <= f[0] <= t1]
    return {
        "attempted": len(done) + len(failed),
        "failed": len(failed),
        "samples": {
            "file_audio_s": sum(len(r["audio"]) for r in done) / synth.SR,
            "segments": len(done),
        },
        "work": [{"samples": len(r["audio"]), "tokens": len(r["tokens"])} for r in done],
        "candidates": [dict(r, file=files[r["owner"]]) for r in done],
    }


def locate(req: dict, sr: int = synth.SR):
    """The harness's own int16 samples of a file-path request: its audio
    matched against its file's samples near each planned start. -> pcm or
    None when no planned segment holds exactly that audio."""
    audio = np.asarray(req["audio"], np.float32)
    pcm = req["file"]["pcm"]
    n = len(audio)
    ref = pcm.astype(np.float32) / 32768.0
    head = audio[: min(n, 256)]
    for start, duration in req["file"]["plan"]:
        if abs(round(duration * sr) - n) > 24:
            continue
        guess = int(round(start * sr))
        for lo in range(max(0, guess - 24), guess + 25):
            if lo + n > len(ref):
                break
            if (np.allclose(ref[lo : lo + len(head)], head, rtol=0, atol=1.5 / 32768)
                    and np.allclose(ref[lo : lo + n], audio, rtol=0, atol=1.5 / 32768)):
                return pcm[lo : lo + n]
    return None
