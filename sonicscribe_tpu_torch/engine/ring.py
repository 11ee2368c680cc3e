"""Device-resident per-stream audio ring: a stream's audio lands on the card once.

Port of the JAX package's ``engine/ring.py``. The WebSocket layer's 64 ms
chunks are packed across all sessions into one int16 upload per scheduler
tick and scattered into a per-stream ring on the device; every consumer
(the batched VAD gate, the mel + prefill of interims and finals) slices
the ring there.

Ring layout: int16 [n_streams+1, 2*RING_CHUNKS, 1024]. Chunk `c` of stream
`s` is written at both (s, c % R) and (s, c % R + R), so any window of up
to R chunks is contiguous at c % R with no wraparound in the consumers.
Row n_streams is the trash stream for padding rows. R = 512 chunks = 32.7 s.

The functions here are indexing and elementwise work, which XLA does in
JAX without Pallas; they are plain PyTorch, written in place on static
tensors so that engine/batcher.py can capture them as CUDA graphs. The
VAD state of every stream lives in one tensor per state field, [n_streams
+ 1] (the last row the padding rows' trash), updated in place by the ring
VAD program; only probabilities go back to the host.
"""

from __future__ import annotations

import torch

from sonicscribe_tpu_torch.audio.mel import MelConfig, log_mel_batch
from sonicscribe_tpu_torch.vad.model import WINDOW_SAMPLES

RING_CHUNKS = 512  # power of two; 512 x 64 ms = 32.7 s
CHUNK_SAMPLES = 1024

# upload batch buckets: padding chunks cost 2 KB of upload each, every
# bucket is one captured program
_SCATTER_BUCKETS = (8, 32, 128, 256)


def scatter_chunks_program(bufs: dict) -> dict:
    """Write packed [M, 1024] int16 chunks into bufs["ring"] in place, each
    at (stream_idx, chunk_id % R) and at + R; padding rows name the trash
    stream."""
    ring, idx = bufs["ring"], bufs["stream_idx"].long()
    pos = torch.remainder(bufs["chunk_ids"].long(), RING_CHUNKS)
    ring[idx, pos] = bufs["packed"]
    ring[idx, pos + RING_CHUNKS] = bufs["packed"]
    return {}


def _slice_stream(ring: torch.Tensor, stream: torch.Tensor, start_chunk: torch.Tensor,
                  n_chunks: int) -> torch.Tensor:
    """[B] streams and start chunks -> [B, n_chunks * 1024] f32 in [-1, 1],
    contiguous in the ring thanks to the double write."""
    pos = torch.remainder(start_chunk.long(), RING_CHUNKS)
    at = pos[:, None] + torch.arange(n_chunks, device=ring.device)[None, :]
    raw = ring[stream.long()[:, None], at]  # [B, n_chunks, 1024]
    return raw.float().reshape(raw.shape[0], -1) / 32768.0


def make_vad_ring_program(vad, window_chunks: int):
    """Batched gate evaluation from the ring with device-resident state.

    -> program(bufs) over bufs ring, states {field: [n_streams + 1]},
    stream_idx [B], start_chunk [B], active [B] and probs [B]: each row's
    window of `window_chunks` chunks through vad.forward one 512-sample
    sub-window at a time, the max probability into probs; the state rows
    of active rows written back in place. Padding rows (active False) read
    the state of their stream_idx and write the trash row, so they never
    disturb a stream's state.
    """
    n_sub = window_chunks * CHUNK_SAMPLES // WINDOW_SAMPLES

    def program(bufs: dict) -> dict:
        idx, active, states = bufs["stream_idx"].long(), bufs["active"], bufs["states"]
        B = idx.shape[0]
        windows = _slice_stream(bufs["ring"], idx, bufs["start_chunk"], window_chunks)
        windows = windows.reshape(B, n_sub, WINDOW_SAMPLES)
        row = {k: v[idx] for k, v in states.items()}
        best = torch.zeros((B,), dtype=torch.float32, device=idx.device)
        for i in range(n_sub):
            probs, row = vad.forward(vad.params, windows[:, i], row)
            best = torch.maximum(best, probs)
        trash = next(iter(states.values())).shape[0] - 1
        write = torch.where(active, idx, trash)
        for k, v in states.items():
            v[write] = row[k]
        bufs["probs"].copy_(best)
        return {}

    return program


def ring_prompt_inputs(ring: torch.Tensor, mel_cfg: MelConfig, stream_idx: torch.Tensor,
                       start_chunk: torch.Tensor, chunk_count: torch.Tensor, n_chunks: int):
    """Slice + per-window peak normalization + batched mel, on the ring's
    device. chunk_count [B] true chunks (<= n_chunks, the static bucket).
    -> (mel [B, T, n_mels], n_frames [B])."""
    audio = _slice_stream(ring, stream_idx, start_chunk, n_chunks)  # [B, N]
    n_samples = chunk_count.long() * CHUNK_SAMPLES
    valid = torch.arange(audio.shape[1], device=audio.device)[None, :] < n_samples[:, None]
    audio = torch.where(valid, audio, 0.0)
    # per-window peak normalization (reference asr.py:263-267 semantics)
    peak = audio.abs().amax(dim=1, keepdim=True)
    audio = torch.where(peak > 1e-8, audio / torch.clamp(peak, min=1e-8), audio)
    return log_mel_batch(audio, n_samples, mel_cfg)
