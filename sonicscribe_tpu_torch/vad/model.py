"""Voice-activity detection: the deterministic energy gate.

Port of ``EnergyVad`` and ``window_probs`` from the JAX package's
``vad/model.py``: speech probability from the SNR of the 100-4000 Hz band
energy of each 512-sample window (16 kHz) over an adaptive noise floor. No
weights. The Silero network comes with a later slice.

For a whole file, ``window_probs`` computes every window's band energy in
one matmul on the device and runs the noise-floor recursion, which is
sequential, on the host (``EnergyVad.gate``, one window per step).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from sonicscribe_tpu_torch.device import resolve_device

WINDOW_SAMPLES = 512
SAMPLE_RATE = 16000


@lru_cache(maxsize=4)
def _band_basis(w: int):
    """(real|imag DFT basis [2*n_bins, w], speech-band mask [n_bins]) f32."""
    n = np.arange(w)
    freqs = np.fft.rfftfreq(w, 1.0 / SAMPLE_RATE)
    band = (freqs >= 100.0) & (freqs <= 4000.0)
    k = np.arange(len(freqs))[:, None]
    ang = 2.0 * np.pi * k * n[None, :] / w
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], 0).astype(np.float32)
    return basis, band.astype(np.float32)


class EnergyVad:
    """Adaptive band-energy VAD: speech probability from the SNR of speech-band
    energy (100-4000 Hz) over a tracked noise floor. Deterministic, no weights.
    """

    window_samples = WINDOW_SAMPLES

    def __init__(self, snr_low_db: float = 3.0, snr_high_db: float = 12.0, device=None):
        self.snr_low = snr_low_db
        self.snr_high = snr_high_db
        self.device = resolve_device(device)

    def init_state(self, batch: int):
        return {
            "noise": torch.full((batch,), 1e-8, device=self.device),
            "init": torch.zeros((batch,), dtype=torch.bool, device=self.device),
        }

    def band_energy(self, windows: torch.Tensor) -> torch.Tensor:
        """windows [B, W] f32 -> mean-square speech-band energy [B]."""
        W = windows.shape[1]
        basis, band = _band_basis(W)
        basis = torch.from_numpy(basis).to(windows.device)
        spec = windows.float() @ basis.T
        nb = band.shape[0]
        power = (spec[:, :nb] ** 2 + spec[:, nb:] ** 2) / (W * W)
        return torch.sum(power * torch.from_numpy(band).to(windows.device)[None], dim=1)

    def gate(self, band_e: torch.Tensor, state):
        """One step of the noise-floor tracker: (band energy [B], state) ->
        (probs [B], new_state)."""
        # first window seeds the noise floor (minimum-statistics style
        # tracker); the seed is capped at an ambient level so a stream that
        # starts mid-speech still detects it
        seed = torch.clamp(band_e * 0.7, 1e-10, 1e-5)
        noise = torch.where(state["init"], state["noise"], seed)
        snr_db = 10.0 * torch.log10(
            torch.clamp(band_e, min=1e-12) / torch.clamp(noise, min=1e-12)
        )
        prob = torch.sigmoid(
            (snr_db - 0.5 * (self.snr_low + self.snr_high))
            * (6.0 / max(self.snr_high - self.snr_low, 1e-3))
        )
        # fast down toward quieter minima, very slow upward creep (so a bad
        # high seed recovers but long speech doesn't swallow the floor)
        new_noise = torch.where(band_e < noise, 0.5 * noise + 0.5 * band_e, noise * 1.0005)
        new_noise = torch.clamp(new_noise, min=1e-10)
        return prob, {"noise": new_noise, "init": torch.ones_like(state["init"])}


def window_probs(vad: EnergyVad, audio: np.ndarray) -> np.ndarray:
    """Run a whole mono 16 kHz signal through `vad`, one stream.
    Returns per-512-sample-window probabilities [ceil(N/512)]."""
    n = len(audio)
    n_win = (n + WINDOW_SAMPLES - 1) // WINDOW_SAMPLES
    padded = np.zeros(n_win * WINDOW_SAMPLES, np.float32)
    padded[:n] = audio
    windows = torch.from_numpy(padded.reshape(n_win, WINDOW_SAMPLES)).to(vad.device)
    energies = vad.band_energy(windows).cpu()
    state = {k: v.cpu() for k, v in vad.init_state(1).items()}
    probs = np.zeros(n_win, np.float32)
    for i in range(n_win):
        p, state = vad.gate(energies[i : i + 1], state)
        probs[i] = float(p[0])
    return probs
