"""Independent PyTorch twin of the Silero-VAD v5 graph.

The port's own copy of the JAX package's ``tools/torch_silero.py``. The
real Silero checkpoint cannot be fetched here, so the port's Silero net
(``vad/model.py:SileroVad``) and its weight converter
(``tools/convert_silero.py``) are checked against an INDEPENDENT
implementation of the same graph, written with plain torch modules. The
reference serves the net through ``silero_vad.load_silero_vad()``
(reference: backend/vad.py:13).

The module hierarchy reproduces the upstream jit export's state-dict names
(`_model.stft.forward_basis_buffer`, `_model.encoder.N.reparam_conv.*`,
`_model.decoder.rnn.*`, `_model.decoder.decoder.2.*`), so a state dict saved
from this twin exercises the converter's real name-mapping and transposes.
Ops use plain torch modules (Conv1d with padding=1, LSTMCell, Sequential
head) rather than mirroring SileroVad's tap gathers and products, so a bug
in shared reasoning shows up as a parity mismatch. ``chip_smoke.py``'s
silero phase runs it on the card.

Graph (v5, 16 kHz path): 512-sample window + 64-sample carried audio context
-> reflect pad 64 -> STFT as conv1d with the stored forward-basis buffer
(258x1x256, stride 128 -> 4 frames x 129 bins magnitude) -> 4 ReLU
Conv1d(k=3, padding=1) blocks with strides 1,2,2,1 (4 frames collapse to 1)
-> LSTMCell(128) -> [Dropout -> ReLU -> Conv1d(128,1,1) -> Sigmoid] head.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _forward_basis(n_fft: int) -> torch.Tensor:
    """Hann-windowed real-DFT basis as a conv weight [2*bins, 1, n_fft],
    the layout upstream stores in `stft.forward_basis_buffer` (torch-stft
    recipe: vstack(real, imag) of the FFT matrix rows times the window)."""
    eye = np.eye(n_fft)
    fb = np.fft.fft(eye)
    cutoff = n_fft // 2 + 1
    basis = np.vstack([np.real(fb[:cutoff]), np.imag(fb[:cutoff])])
    win = np.hanning(n_fft + 1)[:-1]  # periodic hann, matches torch hann_window
    return torch.from_numpy((basis * win[None]).astype(np.float32)).unsqueeze(1)


class _STFT(nn.Module):
    def __init__(self, n_fft: int = 256, hop: int = 128, pad: int = 64):
        super().__init__()
        self.hop = hop
        self.pad = pad
        self.register_buffer("forward_basis_buffer", _forward_basis(n_fft))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: [B, 576] (context + window) -> magnitude [B, bins, frames]
        x = F.pad(x.unsqueeze(1), (self.pad, self.pad), mode="reflect")
        spec = F.conv1d(x, self.forward_basis_buffer, stride=self.hop)
        n_bins = spec.shape[1] // 2
        real, imag = spec[:, :n_bins], spec[:, n_bins:]
        return torch.sqrt(real * real + imag * imag)


class _EncoderBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int, kernel: int = 3):
        super().__init__()
        self.reparam_conv = nn.Conv1d(
            c_in, c_out, kernel, stride=stride, padding=kernel // 2
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.reparam_conv(x))


class _Decoder(nn.Module):
    def __init__(self, hidden: int = 128):
        super().__init__()
        self.rnn = nn.LSTMCell(hidden, hidden)
        # upstream decoder.decoder: 0 Dropout, 1 ReLU, 2 Conv1d, 3 Sigmoid
        self.decoder = nn.Sequential(
            nn.Dropout(0.1), nn.ReLU(), nn.Conv1d(hidden, 1, 1), nn.Sigmoid()
        )


class _SileroV5Model(nn.Module):
    """Inner module; lives under the `_model.` prefix like upstream's jit."""

    def __init__(self):
        super().__init__()
        self.stft = _STFT()
        channels = (129, 128, 64, 64, 128)
        strides = (1, 2, 2, 1)
        self.encoder = nn.Sequential(
            *[
                _EncoderBlock(channels[i], channels[i + 1], strides[i])
                for i in range(4)
            ]
        )
        self.decoder = _Decoder(128)


class TorchSileroVad(nn.Module):
    """Stateful twin with the upstream calling convention:
    `prob = model(window_512, 16000)`; `reset_states()` between streams."""

    CONTEXT = 64

    def __init__(self, seed: int | None = None):
        super().__init__()
        if seed is not None:
            torch.manual_seed(seed)
        self._model = _SileroV5Model()
        self.eval()
        self.reset_states()

    def reset_states(self):
        self._h = None
        self._c = None
        self._ctx = None

    @torch.no_grad()
    def forward(self, x: torch.Tensor, sr: int = 16000) -> torch.Tensor:
        assert sr == 16000, "twin implements the 16 kHz path only"
        B = x.shape[0]
        if self._ctx is None:  # the state on the window's device (the card in chip_smoke)
            self._ctx = torch.zeros(B, self.CONTEXT, device=x.device)
            self._h = torch.zeros(B, 128, device=x.device)
            self._c = torch.zeros(B, 128, device=x.device)
        x = torch.cat([self._ctx, x], dim=1)  # [B, 576]
        self._ctx = x[:, -self.CONTEXT :]
        mag = self._model.stft(x)  # [B, 129, 4]
        feat = self._model.encoder(mag)  # [B, 128, 1]
        self._h, self._c = self._model.decoder.rnn(
            feat.squeeze(-1), (self._h, self._c)
        )
        out = self._model.decoder.decoder(self._h.unsqueeze(-1))  # [B, 1, 1]
        return out[:, 0, 0]


def synthetic_state_dict(seed: int = 0) -> dict[str, np.ndarray]:
    """A random-init state dict carrying the exact upstream tensor names:
    the fixture that gives convert_silero's mapping table and SileroVad
    their numerical check (tests/test_torch_silero.py, chip_smoke.py)."""
    twin = TorchSileroVad(seed=seed)
    return {k: v.detach().numpy().copy() for k, v in twin.state_dict().items()}
