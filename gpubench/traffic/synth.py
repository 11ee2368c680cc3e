"""What the traffic generators share: speech-like audio and spread draws.

Speech is cut from one tape of voiced sound made once per run from the
seed (a gliding pitch with three formant-like partials under a 3-6 Hz
syllable envelope), so that set-up synthesizes a few minutes of audio and
every utterance after that is a slice. Pauses are faint noise.

Lengths are drawn as quasi-random sequences (a start from the seed, then
steps of an irrational fraction through the distribution's quantiles):
any run of consecutive draws has nearly the distribution's mean, so two
seeds give the same mix of lengths in another order, and a window that
ends mid-run does not change the work by luck of the draw.
"""

from __future__ import annotations

import math
import statistics
import struct

import numpy as np

SR = 16000
STEPS = {"utterance": (math.sqrt(5) - 1) / 2, "pause": math.sqrt(2) - 1,
         "file": math.sqrt(3) - 1, "offset": math.sqrt(7) - 2,
         "connect": math.sqrt(11) - 3}
_NORMAL = statistics.NormalDist()


class Draws:
    """One quasi-random sequence per named quantity, each started at a
    point drawn from `rng`."""

    def __init__(self, rng: np.random.Generator):
        self._u = {k: float(rng.random()) for k in STEPS}

    def next_u(self, kind: str) -> float:
        u = self._u[kind]
        self._u[kind] = (u + STEPS[kind]) % 1.0
        return min(max(u, 1e-9), 1 - 1e-9)

    def lognormal(self, kind: str, median: float, sigma: float, lo: float, hi: float) -> float:
        z = _NORMAL.inv_cdf(self.next_u(kind))
        return min(max(median * math.exp(sigma * z), lo), hi)

    def uniform(self, kind: str, lo: float, hi: float) -> float:
        return lo + (hi - lo) * self.next_u(kind)


def speech_tape(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """float32 voiced sound of `seconds` at peak ~0.3."""
    n = int(seconds * SR)
    t = np.arange(n, dtype=np.float64) / SR
    glide = rng.uniform(0.05, 0.2)
    f0 = 150.0 + 60.0 * np.sin(2 * np.pi * glide * t + rng.uniform(0, 2 * np.pi))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    syll = rng.uniform(3.0, 6.0)
    env = 0.35 + 0.65 * 0.5 * (1 + np.sin(2 * np.pi * syll * t + rng.uniform(0, 2 * np.pi)))
    x = (0.5 * np.sin(phase) + 0.3 * np.sin(3.7 * phase) + 0.2 * np.sin(8.3 * phase)
         + 0.12 * np.sin(15.1 * phase))
    x = 0.3 * env * x + 0.002 * rng.standard_normal(n)
    return x.astype(np.float32)


def noise(rng: np.random.Generator, seconds: float) -> np.ndarray:
    return (0.0006 * rng.standard_normal(int(seconds * SR))).astype(np.float32)


def take(tape: np.ndarray, draws: Draws, seconds: float) -> np.ndarray:
    """`seconds` of `tape` from a spread offset, faded in and out over 10 ms."""
    n = max(1, int(seconds * SR))
    start = int(draws.next_u("offset") * (len(tape) - n))
    x = tape[start : start + n].copy()
    fade = min(160, n // 2)
    if fade:
        ramp = np.linspace(0.0, 1.0, fade, dtype=np.float32)
        x[:fade] *= ramp
        x[n - fade :] *= ramp[::-1]
    return x


def to_pcm16(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2")


def wav_bytes(pcm: np.ndarray) -> bytes:
    """16 kHz mono 16-bit PCM WAV of int16 samples."""
    data = np.asarray(pcm, "<i2").tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE" + b"fmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, SR, SR * 2, 2, 16)
            + b"data" + struct.pack("<I", len(data)) + data)
