"""Single-request transcription engine: audio -> text.

Port of the JAX package's ``engine/transcriber.py`` (the reference's
``ASRModel.transcribe``, backend/asr.py:335-488, minus its temp-WAV round
trip): resample and peak-normalise on the device, log-mel padded to a
bucket, encoder + adapter, prompt assembly with the audio at a static
offset and the suffix at the true audio-token count, greedy decode with an
additive hotword logit bias, then the EOS/pad cut.

The buckets keep the prompt shapes of the JAX package, so both produce the
same tokens for the same weights. The serialized-executable store of the
JAX package has no counterpart yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from sonicscribe_tpu_torch.audio.mel import (
    MelConfig,
    device_tables,
    frame_count,
    log_mel_spectrogram,
)
from sonicscribe_tpu_torch.audio.resample import resample
from sonicscribe_tpu_torch.models.config import GlmAsrConfig
from sonicscribe_tpu_torch.models.glm_asr import (
    Params,
    embed_tokens,
    encode_audio,
    greedy_generate,
)
from sonicscribe_tpu_torch.models.tokenizer import DEFAULT_INSTRUCTION, build_prompt

# fixed host-side prompt-layout constants (token counts, not samples)
MAX_SUFFIX_TOKENS = 160  # instruction + hotword suffix, padded to this


def assemble_prompt(
    params: Params,
    cfg: GlmAsrConfig,
    mel: torch.Tensor,  # [1, T_bucket, n_mels]
    n_frames: int,
    prefix_ids: torch.Tensor,  # [P]
    suffix_ids: torch.Tensor,  # [MAX_SUFFIX_TOKENS] pad-filled
    suffix_len: int,
):
    """mel -> (prompt embeddings buffer [1, P+A_max+S, D], total_len [1]).

    The audio slot is written at a static offset, the instruction suffix
    right after the true audio-token count.
    """
    device = mel.device
    audio_embeds, n_tok = encode_audio(
        params, cfg, mel, torch.tensor([n_frames], device=device)
    )
    n_tok = int(n_tok[0])
    A_max = audio_embeds.shape[1]
    P = prefix_ids.shape[0]
    S = suffix_ids.shape[0]
    D = audio_embeds.shape[-1]

    buf = torch.zeros((1, P + A_max + S, D), dtype=audio_embeds.dtype, device=device)
    buf[0, :P] = embed_tokens(params, prefix_ids)
    buf[:, P : P + A_max] = audio_embeds
    buf[0, P + n_tok : P + n_tok + S] = embed_tokens(params, suffix_ids)
    total_len = torch.tensor([P + n_tok + suffix_len], dtype=torch.int32, device=device)
    return buf, total_len


@dataclass
class TranscribeResult:
    text: str
    tokens: np.ndarray
    audio_duration_s: float
    timings: dict = field(default_factory=dict)


class Transcriber:
    """Owns params on one device; transcribes one request at a time.

    `stats` counts requests and the decode steps they ran.
    """

    def __init__(
        self,
        cfg: GlmAsrConfig,
        params: Params,
        tokenizer,
        mel_cfg: MelConfig | None = None,
        prefill_buckets: Sequence[int] = (128, 256, 512, 1024, 2048, 3072),
        peak_normalize: bool = True,
        hotword_bias_strength: float = 3.0,
    ):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.mel_cfg = mel_cfg or MelConfig(n_mels=cfg.encoder.n_mels)
        self.buckets = sorted(prefill_buckets)
        self.peak_normalize = peak_normalize
        self.hotword_bias_strength = hotword_bias_strength
        embed = params["decoder"]["embed"]
        self.device = embed.device
        self.dtype = embed.dtype
        self.stats = {"requests": 0, "decode_steps": 0}
        device_tables(self.mel_cfg, self.device)  # a front end the card cannot run raises here

    # ---- host-side helpers ----

    def _pick_bucket(self, frames: int) -> int:
        for b in self.buckets:
            if frames <= b:
                return b
        return self.buckets[-1]

    def _hotword_logit_bias(self, hotwords: Optional[list[str]]) -> torch.Tensor | None:
        if not hotwords or self.hotword_bias_strength == 0.0:
            return None
        bias = np.zeros((self.cfg.decoder.vocab_size,), np.float32)
        for w in hotwords[:10]:
            for tid in self.tokenizer.encode(str(w).strip().lower()):
                bias[tid] = self.hotword_bias_strength
        return torch.from_numpy(bias).to(self.device)

    def prepare_audio(self, audio: np.ndarray, sample_rate: int) -> torch.Tensor:
        """Resample to the model rate + optional peak normalization
        (reference asr.py:255-267 semantics), on the params' device."""
        target = self.mel_cfg.sampling_rate
        x = torch.as_tensor(np.asarray(audio, np.float32), device=self.device)
        x = resample(x, sample_rate, target)
        if self.peak_normalize:
            peak = x.abs().max()
            x = torch.where(peak > 1e-8, x / torch.clamp(peak, min=1e-8), x)
        return x

    # ---- main entry ----

    def transcribe(
        self,
        audio: np.ndarray,
        sample_rate: int,
        max_new_tokens: int = 256,
        hotwords: Optional[list[str]] = None,
        instruction: str = DEFAULT_INSTRUCTION,
    ) -> TranscribeResult:
        t0 = time.perf_counter()
        x = self.prepare_audio(audio, sample_rate)
        duration = float(x.shape[0]) / self.mel_cfg.sampling_rate

        frames = max(1, frame_count(int(x.shape[0]), self.mel_cfg))
        bucket = self._pick_bucket(frames)
        if frames > bucket:  # clamp over-long audio to the largest bucket
            frames = bucket
            x = x[: bucket * self.mel_cfg.hop_length]
        mel = log_mel_spectrogram(x, self.mel_cfg, pad_to_frames=bucket)[None]
        t_mel = time.perf_counter()

        prompt = build_prompt(self.tokenizer, self.cfg, instruction, hotwords)
        suffix = np.full((MAX_SUFFIX_TOKENS,), self.cfg.pad_id, np.int32)
        s = prompt.suffix_ids[:MAX_SUFFIX_TOKENS]
        suffix[: len(s)] = s

        with torch.inference_mode():
            buf, total_len = assemble_prompt(
                self.params,
                self.cfg,
                mel.to(self.dtype),
                frames,
                torch.from_numpy(prompt.prefix_ids).to(self.device),
                torch.from_numpy(suffix).to(self.device),
                len(s),
            )
            toks, steps = greedy_generate(
                self.params, self.cfg, buf, total_len, max_new_tokens,
                logit_bias=self._hotword_logit_bias(hotwords),
            )
        toks = toks[0].cpu().numpy()
        t_gen = time.perf_counter()
        self.stats["requests"] += 1
        self.stats["decode_steps"] += steps

        # cut at EOS / pads
        out = []
        for t in toks:
            if t == self.cfg.eos_id or t == self.cfg.pad_id:
                break
            out.append(int(t))
        text = self.tokenizer.decode(out)

        return TranscribeResult(
            text=text,
            tokens=np.asarray(out, np.int32),
            audio_duration_s=duration,
            timings={
                "mel_s": t_mel - t0,
                "generate_s": t_gen - t_mel,
                "total_s": t_gen - t0,
                "rtf": (t_gen - t0) / max(duration, 1e-6),
                "mel_bucket": bucket,
            },
        )

    def warmup(self, buckets: Optional[Sequence[int]] = None,
               budgets: Sequence[int] = (256,)) -> None:
        """Run each (bucket, budget) once: builds the CUDA kernels and
        warms PyTorch's allocator and library handles."""
        sr = self.mel_cfg.sampling_rate
        for b in buckets or self.buckets:
            n = b * self.mel_cfg.hop_length
            for budget in budgets:
                self.transcribe(np.zeros(n, np.float32), sr, max_new_tokens=budget)
