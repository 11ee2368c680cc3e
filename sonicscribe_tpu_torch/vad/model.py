"""Voice-activity detection: the energy gate and the Silero network.

Port of the JAX package's ``vad/model.py``. Every VAD here runs on
512-sample windows at 16 kHz and shares one interface:

- ``forward(params, windows [B, 512], state) -> (probs [B], state)``: one
  window per stream, the JAX package's per-window step;
- ``forward_windows(params, windows [B, n, 512], state) -> (probs [B, n],
  state)``: n consecutive windows per stream, all on the windows' device
  (the batcher's ring and host-audio programs, captured as CUDA graphs);
- ``window_probs_state(x [n, 512], state) -> (probs [n], state)``: one
  stream's n consecutive windows, the probabilities on the host (a stream's
  gate window on the threaded engine, and ``window_probs`` for a file).

State is a flat ``{field: tensor}`` dict with the stream axis first, the
form the batcher's state rows and the ring's write-back index.

- ``EnergyVad``: speech probability from the SNR of the 100-4000 Hz band
  energy over an adaptive noise floor. No weights. Its whole-window method
  takes every window's band energy in one matmul on the device, then runs
  the noise-floor recursion, which is sequential, on the host
  (``gate_on_host``).
- ``SileroVad``: the Silero-VAD v5 network (STFT magnitude, four convs, an
  LSTM cell, a sigmoid head), weights from ``tools/convert_silero.py``.
  Only the LSTM cell is sequential: ``features`` runs the front end and the
  convs over every window of a batch at once, ``cell`` the recursion.
- ``SileroCostProbeVad``: the Silero forward run for its cost, the energy
  gate's probabilities as its output (a benchmark's gate without weights).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sonicscribe_tpu_torch.device import resolve_device

WINDOW_SAMPLES = 512
SAMPLE_RATE = 16000


def _windows_on(x, device) -> torch.Tensor:
    """[n, 512] numpy or tensor -> float32 tensor on `device`."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return x.to(device=device, dtype=torch.float32)


# ---------------------------------------------------------------------
# Silero-architecture model
# ---------------------------------------------------------------------


@dataclass(frozen=True)
class SileroConfig:
    """Silero-VAD v5 graph constants (the JAX package's, recovered from the
    public jit/ONNX export's op structure):

    512-sample window + 64-sample carried context -> reflect pad ->
    STFT as a product with a stored forward basis (129 bins x 4 frames)
    -> 4 ReLU conv1d blocks (strides 1,2,2,1: 4 frames collapse to 1)
    -> LSTMCell(128) -> [ReLU -> 1x1 conv -> sigmoid] head.
    """

    n_fft: int = 256
    hop: int = 128
    context: int = 64  # samples of left context carried between windows
    pad: int = 64  # reflect padding applied around the 576-sample input
    conv_channels: Tuple[int, ...] = (128, 64, 64, 128)
    conv_strides: Tuple[int, ...] = (1, 2, 2, 1)
    kernel: int = 3
    lstm_hidden: int = 128

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1


def _tree_to(tree, device):
    """A Silero params tree (numpy or tensor leaves) -> float32 tensors on
    `device`, the same nesting."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree, np.float32))
    return tree.to(device=device, dtype=torch.float32)


class SileroVad:
    """Silero-VAD v5 speech-probability net.

    Params have the JAX package's layout (conv weights [k, in, out], dense
    [in, out], one LSTM bias, the STFT basis [2 * bins, n_fft] under
    ``stft.basis``). State per stream: ``h``, ``c`` [B, 128] and ``ctx``
    [B, 64], the tail of the previous window. Float32 throughout; TF32 is
    off (device.resolve_device), so a product on the card is full float32.
    """

    window_samples = WINDOW_SAMPLES

    def __init__(self, params=None, cfg: SileroConfig = SileroConfig(), device=None,
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = self.init_params(seed)
        self.params = _tree_to(params, self.device)
        self._index: dict = {}  # (name, device) -> gather index on that device

    def to(self, device) -> "SileroVad":
        """The same net on `device` (a data-parallel replica's VAD)."""
        return SileroVad(params=self.params, cfg=self.cfg, device=device)

    def _dft_basis(self) -> np.ndarray:
        """Analytic hann-windowed real-DFT basis [2*bins, n_fft]."""
        cfg = self.cfg
        n = np.arange(cfg.n_fft)
        k = np.arange(cfg.n_bins)[:, None]
        ang = 2.0 * np.pi * k * n[None, :] / cfg.n_fft
        win = 0.5 * (1 - np.cos(2 * np.pi * n / cfg.n_fft))
        return np.concatenate(
            [np.cos(ang) * win[None], -np.sin(ang) * win[None]], 0
        ).astype(np.float32)

    def init_params(self, seed: int) -> dict:
        """Random weights at the JAX package's shapes and scales (normal x
        0.05, zero biases, the analytic basis), drawn on the CPU from a
        torch.Generator seeded with `seed`, so that a seed gives the same
        tree on every device. Useful for shapes and cost only."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(seed)

        def dense(*shape):
            return torch.randn(shape, generator=gen, dtype=torch.float32) * 0.05

        convs = []
        c_in = cfg.n_bins
        for c_out in cfg.conv_channels:
            convs.append({"w": dense(cfg.kernel, c_in, c_out), "b": torch.zeros(c_out)})
            c_in = c_out
        h = cfg.lstm_hidden
        return {
            "stft": {"basis": torch.from_numpy(self._dft_basis())},
            "convs": convs,
            "lstm": {"wi": dense(c_in, 4 * h), "wh": dense(h, 4 * h), "b": torch.zeros(4 * h)},
            "out": {"w": dense(h, 1), "b": torch.zeros(1)},
        }

    def init_state(self, batch: int):
        h = self.cfg.lstm_hidden
        return {
            "h": torch.zeros((batch, h), device=self.device),
            "c": torch.zeros((batch, h), device=self.device),
            "ctx": torch.zeros((batch, self.cfg.context), device=self.device),
        }

    def _idx(self, name: str, device, make) -> torch.Tensor:
        key = (name, device)
        if key not in self._index:  # uploaded once, not per call
            self._index[key] = torch.from_numpy(make()).to(device)
        return self._index[key]

    def features(self, params, x: torch.Tensor) -> torch.Tensor:
        """x [N, 576] (64 samples of context, then the window) -> the conv
        encoder's output [N, 128], every row at once."""
        cfg = self.cfg
        # reflect pad then STFT magnitude via the (stored) basis:
        # [N, 576] -> [N, 704] -> 4 frames of n_fft at stride hop
        x = F.pad(x[:, None, :], (cfg.pad, cfg.pad), mode="reflect")[:, 0]
        frames = x.unfold(1, cfg.n_fft, cfg.hop)  # [N, F, n_fft]
        basis = params.get("stft", {}).get("basis")
        if basis is None:  # pre-v5-layout converted params
            basis = self._idx("basis", x.device, self._dft_basis).float()
        spec = frames @ basis.T
        real, imag = spec[..., : cfg.n_bins], spec[..., cfg.n_bins :]
        h = torch.sqrt(real**2 + imag**2 + 1e-12)  # [N, F, bins]

        # conv1d with symmetric padding k//2 (upstream's Conv1d(padding=1)),
        # channels last: the k taps of each output frame gathered side by
        # side, one product with the [k * in, out] weight. Not "SAME": for
        # stride 2 that pads (0, 1) here and shifts the taps off upstream's.
        half = cfg.kernel // 2
        for conv, stride in zip(params["convs"], cfg.conv_strides):
            T = h.shape[1]
            T_out = (T + 2 * half - cfg.kernel) // stride + 1
            idx = self._idx(("taps", T, stride), h.device, lambda T_out=T_out, stride=stride: (
                np.arange(T_out)[:, None] * stride + np.arange(cfg.kernel)[None, :]))
            hp = F.pad(h, (0, 0, half, half))  # [N, T + 2, C]
            taps = hp[:, idx].reshape(h.shape[0], T_out, -1)  # [N, T_out, k * C]
            w = conv["w"]
            h = torch.relu(taps @ w.reshape(-1, w.shape[-1]) + conv["b"])
        # strides (1,2,2,1) collapse the 4 STFT frames to one
        return h.mean(dim=1)

    def cell(self, params, feat: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        """One LSTM step (gates i, f, g, o; one summed bias) and the head:
        (feat [B, 128], h, c) -> (probs [B], h, c)."""
        lp = params["lstm"]
        gates = feat @ lp["wi"] + h @ lp["wh"] + lp["b"]
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        # decoder head: Dropout (identity at inference) -> ReLU -> 1x1 conv
        # -> sigmoid
        prob = torch.sigmoid(torch.relu(h) @ params["out"]["w"] + params["out"]["b"])[:, 0]
        return prob, h, c

    def forward(self, params, windows: torch.Tensor, state):
        """windows [B, 512] float32 -> (probs [B], new_state)."""
        x = torch.cat([state["ctx"], windows], dim=1)  # [B, 576]
        prob, h, c = self.cell(params, self.features(params, x), state["h"], state["c"])
        return prob, {"h": h, "c": c, "ctx": windows[:, -self.cfg.context :]}

    def forward_windows(self, params, windows: torch.Tensor, state):
        """windows [B, n, 512] -> (probs [B, n], state after the n-th): the
        front end of all B * n windows in one pass (window i's context is
        the tail of window i - 1, the first's the state's), then n cells."""
        B, n, W = windows.shape
        ctx = self.cfg.context
        flat = torch.cat([state["ctx"], windows.reshape(B, n * W)], dim=1)
        x = flat.unfold(1, W + ctx, W)  # [B, n, 576]
        feat = self.features(params, x.reshape(B * n, W + ctx)).reshape(B, n, -1)
        h, c, probs = state["h"], state["c"], []
        for i in range(n):
            p, h, c = self.cell(params, feat[:, i], h, c)
            probs.append(p)
        return torch.stack(probs, dim=1), {"h": h, "c": c, "ctx": windows[:, -1, -ctx:]}

    def window_probs_state(self, x, state):
        """One stream's windows x [n, 512] from `state` (None: a fresh
        stream) -> (probs [n] on the host, the state after them on the
        device)."""
        if state is None:
            state = self.init_state(1)
        if len(x) == 0:
            return np.zeros(0, np.float32), state
        with torch.inference_mode():
            probs, state = self.forward_windows(
                self.params, _windows_on(x, self.device)[None], state)
            return probs[0].cpu().numpy(), state


# ---------------------------------------------------------------------
# Deterministic DSP gate
# ---------------------------------------------------------------------


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
        self.params = None  # no weights; forward's signature is the Silero net's
        self.snr_low = snr_low_db
        self.snr_high = snr_high_db
        self.device = resolve_device(device)
        self._tables: dict = {}  # (W, device) -> (DFT basis, band mask) on that device

    def to(self, device) -> "EnergyVad":
        """The same gate on `device` (a data-parallel replica's VAD)."""
        return EnergyVad(self.snr_low, self.snr_high, device=device)

    def init_state(self, batch: int):
        return {
            "noise": torch.full((batch,), 1e-8, device=self.device),
            "init": torch.zeros((batch,), dtype=torch.bool, device=self.device),
        }

    def band_energy(self, windows: torch.Tensor) -> torch.Tensor:
        """windows [B, W] f32 -> mean-square speech-band energy [B]."""
        W = windows.shape[1]
        key = (W, windows.device)
        if key not in self._tables:  # uploaded once, not per window
            self._tables[key] = tuple(torch.from_numpy(t).to(windows.device)
                                      for t in _band_basis(W))
        basis, band = self._tables[key]
        spec = windows.float() @ basis.T
        nb = band.shape[0]
        power = (spec[:, :nb] ** 2 + spec[:, nb:] ** 2) / (W * W)
        return torch.sum(power * band[None], dim=1)

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

    def forward(self, params, windows: torch.Tensor, state):
        """One window per stream: (windows [B, W], state) -> (probs [B],
        new_state), the JAX package's EnergyVad.forward."""
        del params
        return self.gate(self.band_energy(windows), state)

    def forward_windows(self, params, windows: torch.Tensor, state):
        """windows [B, n, W] -> (probs [B, n], state): forward window by
        window, on the windows' device."""
        probs = []
        for i in range(windows.shape[1]):
            p, state = self.forward(params, windows[:, i], state)
            probs.append(p)
        return torch.stack(probs, dim=1), state

    def window_probs_state(self, x, state):
        """One stream's windows x [n, W]: their band energies in one matmul
        on the device and one copy back, then the noise-floor recursion on
        the host from `state` (None: a fresh stream). -> (probs [n], the
        state after them, on the CPU)."""
        with torch.inference_mode():
            energies = self.band_energy(_windows_on(x, self.device)).cpu()
            return gate_on_host(self, energies, state)


def gate_on_host(vad: EnergyVad, energies: torch.Tensor, state) -> tuple[np.ndarray, dict]:
    """The noise-floor recursion of one stream over its windows' band
    energies [n] on the CPU, from `state` (None: a fresh stream).
    -> (probs [n], the state after the last window, on the CPU)."""
    if state is None:
        state = {k: v.cpu() for k, v in vad.init_state(1).items()}
    else:
        state = {k: torch.as_tensor(v).cpu() for k, v in state.items()}
    probs = np.zeros(len(energies), np.float32)
    for i in range(len(energies)):
        p, state = vad.gate(energies[i : i + 1], state)
        probs[i] = float(p[0])
    return probs, state


# ---------------------------------------------------------------------
# Silero's cost, the energy gate's decisions
# ---------------------------------------------------------------------


def _split(state: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def _join(nn_state: dict, energy_state: dict) -> dict:
    return {**{f"nn_{k}": v for k, v in nn_state.items()},
            **{f"energy_{k}": v for k, v in energy_state.items()}}


class SileroCostProbeVad:
    """Runs SileroVad's forward for its device cost; gates with EnergyVad's
    output.

    For measuring serving with the network's cost where no Silero weights
    exist (random-init probabilities would break segmentation): the
    latency includes the Silero v5 forward exactly as a converted
    checkpoint would, and the decisions are the energy gate's, bit for bit
    (``e_probs + 0.0 * nn_probs``). State is the two VADs' fields, flat:
    ``nn_h``, ``nn_c``, ``nn_ctx``, ``energy_noise``, ``energy_init``.
    """

    window_samples = WINDOW_SAMPLES

    def __init__(self, device=None, seed: int = 0, nn=None, energy=None):
        self.nn = nn or SileroVad(device=device, seed=seed)
        self.energy = energy or EnergyVad(device=self.nn.device)
        self.device = self.nn.device
        self.params = {"nn": self.nn.params}

    def to(self, device) -> "SileroCostProbeVad":
        """The same probe on `device` (a data-parallel replica's VAD)."""
        return SileroCostProbeVad(nn=self.nn.to(device), energy=self.energy.to(device))

    def init_state(self, batch: int):
        return _join(self.nn.init_state(batch), self.energy.init_state(batch))

    def _both(self, method: str, params, windows, state):
        nn_probs, nn_state = getattr(self.nn, method)(params["nn"], windows, _split(state, "nn_"))
        e_probs, e_state = getattr(self.energy, method)(None, windows, _split(state, "energy_"))
        # keep the network's output in the result so that its work is done
        return e_probs + 0.0 * nn_probs, _join(nn_state, e_state)

    def forward(self, params, windows: torch.Tensor, state):
        return self._both("forward", params, windows, state)

    def forward_windows(self, params, windows: torch.Tensor, state):
        return self._both("forward_windows", params, windows, state)

    def window_probs_state(self, x, state):
        state = state if state is not None else self.init_state(1)
        nn_probs, nn_state = self.nn.window_probs_state(x, _split(state, "nn_"))
        e_probs, e_state = self.energy.window_probs_state(x, _split(state, "energy_"))
        return e_probs + np.float32(0.0) * nn_probs, _join(nn_state, e_state)


def window_probs(vad, audio: np.ndarray) -> np.ndarray:
    """Run a whole mono 16 kHz signal through `vad` (any of the three), one
    stream. Returns per-512-sample-window probabilities [ceil(N/512)]."""
    n = len(audio)
    n_win = (n + WINDOW_SAMPLES - 1) // WINDOW_SAMPLES
    padded = np.zeros(n_win * WINDOW_SAMPLES, np.float32)
    padded[:n] = audio
    return vad.window_probs_state(padded.reshape(n_win, WINDOW_SAMPLES), None)[0]
