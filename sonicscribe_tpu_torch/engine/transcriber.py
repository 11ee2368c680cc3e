"""Single-request transcription engine: audio -> text.

Port of the JAX package's ``engine/transcriber.py`` (the reference's
``ASRModel.transcribe``, backend/asr.py:335-488, minus its temp-WAV round
trip): resample and peak-normalise on the device, log-mel padded to a
bucket, encoder + adapter, prompt assembly with the audio at a static
offset and the suffix at the true audio-token count, greedy decode with an
additive hotword logit bias, then the EOS/pad cut.

The buckets keep the prompt shapes of the JAX package, so both produce the
same tokens for the same weights. JAX runs a request as one compiled
program per (mel bucket, budget, prefix length), ``_transcribe_program``.
Here it is two programs over static buffers, because the host has to see
EOS between decode chunks and a CUDA graph cannot branch on it:

- ``_prompt_program``: encoder and adapter on the mel bucket, prompt
  assembly (the suffix written at a device offset), prefill and the first
  token; one per (bucket, prefix length);
- ``_decode_k_program``: k greedy steps (the JAX batcher's
  ``_decode_k_program``) on a static cache, token, done flag, step count,
  budget and output row; one per (bucket, budget ceiling, k). The host
  reads the done flag once per chunk.

Budget ceilings. A request of budget b runs on the buffers and graph of
the smallest ceiling of ``BUDGET_CEILINGS`` that is >= b (a budget above
them all is its own ceiling): b sits in a static buffer that the graph
reads, the host replays the graph ceil(b / k) times, and the at most
k - 1 steps past b write nothing. So a streaming final, whose budget
follows its duration, captures no graph on its request path and leaves
no buffer behind. The JAX package compiles one program per exact budget.

``engine/exec_store.py``'s ``GraphRouter`` captures each as a CUDA graph
on the card and replays it, or runs it eagerly on the CPU. The mel, the
resampling and the peak normalisation run before the programs, as in JAX.

A tensor-parallel rank (engine/replicas.py) is a Transcriber over its
shard tree (parallel/mesh.py:shard_params_tp, its hook under "tp") and
its rank-local config, on its card, with a router of its own; the
batcher drives the ranks' programs in lockstep (engine/batcher.py). Its
own ``transcribe`` would run one rank alone, whose all-reduces nobody
meets, so it raises.
"""

from __future__ import annotations

import functools
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
from sonicscribe_tpu_torch.engine.exec_store import GraphRouter
from sonicscribe_tpu_torch.models.config import GlmAsrConfig
from sonicscribe_tpu_torch.models.glm_asr import (
    Params,
    decode_step,
    embed_tokens,
    encode_audio,
    init_cache,
    prefill_kv,
)
from sonicscribe_tpu_torch.models.tokenizer import DEFAULT_INSTRUCTION, build_prompt

# fixed host-side prompt-layout constants (token counts, not samples)
MAX_SUFFIX_TOKENS = 160  # instruction + hotword suffix, padded to this
# decode steps per graph: the least wall of chip_smoke.py's A/B (k 4, 8, 16,
# 32) on segments that end in EOS (PERF.md). A segment runs up to k - 1
# steps past its EOS, to the end of its chunk; each chunk costs a graph
# launch and a host read of the done flag.
DECODE_STEPS = 4
# the app's budget grid (config.py: interim, final maximum, file): the
# decode buffers and graphs are kept per ceiling, not per exact budget
BUDGET_CEILINGS = (15, 200, 256)


def assemble_prompt(
    params: Params,
    cfg: GlmAsrConfig,
    mel: torch.Tensor,  # [1, T_bucket, n_mels]
    n_frames: torch.Tensor,  # [1] int32
    prefix_ids: torch.Tensor,  # [P]
    suffix_ids: torch.Tensor,  # [MAX_SUFFIX_TOKENS] pad-filled
    suffix_len: torch.Tensor,  # [1] int32
):
    """mel -> (prompt embeddings buffer [1, P+A_max+S, D], total_len [1] int32).

    The audio slot is written at a static offset, the instruction suffix at
    P + the true audio-token count, a device tensor (JAX's traced
    dynamic_update_slice), so one captured program serves every audio
    length within a bucket.
    """
    audio_embeds, n_tok = encode_audio(params, cfg, mel, n_frames)
    A_max = audio_embeds.shape[1]
    P = prefix_ids.shape[0]
    S = suffix_ids.shape[0]
    D = audio_embeds.shape[-1]
    device = mel.device

    buf = torch.zeros((1, P + A_max + S, D), dtype=audio_embeds.dtype, device=device)
    buf[0, :P] = embed_tokens(params, prefix_ids)
    buf[:, P : P + A_max] = audio_embeds
    at = P + n_tok.long() + torch.arange(S, device=device)
    buf[0].index_copy_(0, at, embed_tokens(params, suffix_ids))
    return buf, P + n_tok + suffix_len


def _pick(cfg: GlmAsrConfig, logits, bias, done=None) -> torch.Tensor:
    """Greedy token of biased logits [B, V]; a pad where `done`."""
    tok = torch.argmax(logits + bias, dim=-1).to(torch.int32)
    if done is None:
        return tok
    return torch.where(done, cfg.pad_id, tok).to(torch.int32)


def _prompt_program(params: Params, cfg: GlmAsrConfig, bufs: dict) -> dict:
    """mel bucket -> prefill K/V [L, 1, S_prompt, nkv, hd], the prompt's
    true length [1] and its first token [1]."""
    buf, total_len = assemble_prompt(
        params, cfg, bufs["mel"], bufs["n_frames"], bufs["prefix_ids"],
        bufs["suffix_ids"], bufs["suffix_len"],
    )
    ks, vs, logits = prefill_kv(params, cfg, buf, total_len)
    return {"k": ks, "v": vs, "len": total_len, "tok": _pick(cfg, logits, bufs["bias"])}


def _decode_k_program(params: Params, cfg: GlmAsrConfig, bufs: dict, k: int) -> dict:
    """k greedy steps on the decode buffers, in place. Each step is a step
    of the JAX package's greedy_generate scan: it marks the row done at
    EOS, writes the current token at the step count (nothing once the
    count reaches the request's budget, a buffer the graph reads), runs the
    decode step and picks the next token (a pad once done)."""
    cache = {"k": bufs["k"], "v": bufs["v"], "len": bufs["len"]}
    tok, done, n, out = bufs["tok"], bufs["done"], bufs["n"], bufs["out"]
    last = out.shape[1] - 1
    for _ in range(k):
        done |= tok == cfg.eos_id
        at = torch.clamp(n, max=last).long()[:, None]
        out.scatter_(1, at, torch.where((n < bufs["budget"])[:, None], tok[:, None],
                                        out.gather(1, at)))
        _, logits = decode_step(params, cfg, cache, tok, active=~done)
        tok.copy_(_pick(cfg, logits, bufs["bias"], done))
        n += 1
    return {}


def start_decode(cfg: GlmAsrConfig, bufs: dict, prompt: dict, budget: int) -> None:
    """Load _prompt_program's outputs and the request's budget into the
    decode buffers."""
    S = prompt["k"].shape[2]
    bufs["k"][:, :, :S].copy_(prompt["k"])
    bufs["v"][:, :, :S].copy_(prompt["v"])
    bufs["len"].copy_(prompt["len"])
    bufs["tok"].copy_(prompt["tok"])
    bufs["done"].zero_()
    bufs["n"].zero_()
    bufs["budget"].fill_(budget)
    bufs["out"].fill_(cfg.pad_id)


def budget_ceiling(budget: int) -> int:
    """The smallest of BUDGET_CEILINGS that is >= budget, or the budget
    itself above them all."""
    return min((c for c in BUDGET_CEILINGS if c >= budget), default=budget)


@dataclass
class TranscribeResult:
    text: str
    tokens: np.ndarray
    audio_duration_s: float
    timings: dict = field(default_factory=dict)


class Transcriber:
    """Owns params on one device; transcribes one request at a time, on
    one thread (the graphs share their buffers and memory pool).

    `stats` counts requests, the decode steps they ran on the device (every
    step of every replayed chunk) and the tokens they generated (up to EOS,
    EOS included);
    `router.stats` counts graphs, replays and capture seconds.
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
        self.stats = {"requests": 0, "decode_steps": 0, "tokens": 0}
        device_tables(self.mel_cfg, self.device)  # a front end the card cannot run raises here
        self.router = GraphRouter(self.device)
        # the hotword logit bias every program reads: zero without hotwords,
        # as JAX's _zero_bias (adding 0.0 leaves each logit as it was)
        self._bias = torch.zeros((cfg.decoder.vocab_size,), dtype=torch.float32,
                                 device=self.device)
        self._bufs: dict = {}  # static buffers by key
        self._prompt_fn = functools.partial(_prompt_program, params, cfg)

    # ---- host-side helpers ----

    def _pick_bucket(self, frames: int) -> int:
        for b in self.buckets:
            if frames <= b:
                return b
        return self.buckets[-1]

    def _set_logit_bias(self, hotwords: Optional[list[str]]) -> None:
        """Write the hotword logit bias into the static bias buffer."""
        if not hotwords or self.hotword_bias_strength == 0.0:
            self._bias.zero_()
            return
        bias = np.zeros((self.cfg.decoder.vocab_size,), np.float32)
        for w in hotwords[:10]:
            for tid in self.tokenizer.encode(str(w).strip().lower()):
                bias[tid] = self.hotword_bias_strength
        self._bias.copy_(torch.from_numpy(bias))

    def prepare_audio(self, audio: np.ndarray, sample_rate: int) -> torch.Tensor:
        """Resample to the model rate + optional peak normalization
        (reference asr.py:255-267 semantics), on the params' device."""
        target = self.mel_cfg.sampling_rate
        x = torch.from_numpy(np.ascontiguousarray(audio, np.float32))
        if self.device.type == "cuda":  # through pinned memory: no wait for the stream
            x = x.pin_memory().to(self.device, non_blocking=True)
        x = resample(x, sample_rate, target)
        if self.peak_normalize:
            peak = x.abs().max()
            x = torch.where(peak > 1e-8, x / torch.clamp(peak, min=1e-8), x)
        return x

    # ---- static buffers and programs ----

    def _prompt_bufs(self, bucket: int, prefix_len: int) -> dict:
        """Static inputs of _prompt_program for one (bucket, prefix length)."""
        key = ("prompt", bucket, prefix_len)
        if key not in self._bufs:
            dev, i32, pad = self.device, torch.int32, self.cfg.pad_id
            self._bufs[key] = {
                "mel": torch.zeros((1, bucket, self.mel_cfg.n_mels), dtype=self.dtype, device=dev),
                "n_frames": torch.ones((1,), dtype=i32, device=dev),
                "prefix_ids": torch.full((prefix_len,), pad, dtype=i32, device=dev),
                "suffix_ids": torch.full((MAX_SUFFIX_TOKENS,), pad, dtype=i32, device=dev),
                "suffix_len": torch.zeros((1,), dtype=i32, device=dev),
                "bias": self._bias,
            }
        return self._bufs[key]

    def _decode_bufs(self, bucket: int, ceiling: int, prefix_len: int, prompt_len: int) -> dict:
        """Static state of _decode_k_program for one (bucket, budget ceiling,
        prefix length): a cache of prompt_len + ceiling positions, the
        current token, done flag, step count, the request's budget and an
        output row of `ceiling` tokens."""
        key = ("decode", bucket, ceiling, prefix_len)
        if key not in self._bufs:
            dev, i32 = self.device, torch.int32
            self._bufs[key] = {
                **init_cache(self.cfg, 1, prompt_len + ceiling, dtype=self.dtype, device=dev),
                "tok": torch.zeros((1,), dtype=i32, device=dev),
                "done": torch.zeros((1,), dtype=torch.bool, device=dev),
                "n": torch.zeros((1,), dtype=i32, device=dev),
                "budget": torch.full((1,), ceiling, dtype=i32, device=dev),
                "out": torch.full((1, ceiling), self.cfg.pad_id, dtype=i32, device=dev),
                "bias": self._bias,
            }
        return self._bufs[key]

    def _decode_fn(self, k: int):
        return functools.partial(_decode_k_program, self.params, self.cfg, k=k)

    def _generate(self, bucket: int, mel: torch.Tensor, frames: int, prefix_ids: np.ndarray,
                  suffix_ids: np.ndarray, suffix_len: int, budget: int) -> tuple[np.ndarray, int]:
        """The two programs through the router, with the bias buffer set;
        the decode graph of the budget's ceiling replayed until EOS or
        `budget` steps. -> (tokens [budget], pad-filled after EOS; decode
        steps run)."""
        P = len(prefix_ids)
        p = self._prompt_bufs(bucket, P)
        p["mel"].copy_(mel)
        p["n_frames"].fill_(frames)
        p["prefix_ids"].copy_(torch.from_numpy(prefix_ids))
        p["suffix_ids"].copy_(torch.from_numpy(suffix_ids))
        p["suffix_len"].fill_(suffix_len)
        prompt = self.router.run(("prompt", bucket, P), self._prompt_fn, p)
        ceiling, k = budget_ceiling(budget), DECODE_STEPS
        d = self._decode_bufs(bucket, ceiling, P, prompt["k"].shape[2])
        start_decode(self.cfg, d, prompt, budget)
        steps = 0
        while steps < budget:
            self.router.run(("decode", bucket, ceiling, k, P), self._decode_fn(k), d)
            steps += k
            if steps < budget and bool(d["done"].all()):  # the host's one read per chunk
                break
        return d["out"][0, :budget].cpu().numpy(), steps

    # ---- main entry ----

    def transcribe(
        self,
        audio: np.ndarray,
        sample_rate: int,
        max_new_tokens: int = 256,
        hotwords: Optional[list[str]] = None,
        instruction: str = DEFAULT_INSTRUCTION,
    ) -> TranscribeResult:
        if "tp" in self.params:
            raise NotImplementedError("a tensor-parallel rank's Transcriber serves through its "
                                      "row's batcher (engine/replicas.py), which runs every rank")
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
            self._set_logit_bias(hotwords)
            toks, steps = self._generate(bucket, mel, frames, prompt.prefix_ids, suffix,
                                         len(s), max_new_tokens)
        t_gen = time.perf_counter()

        # cut at EOS / pads
        out = []
        for t in toks:
            if t == self.cfg.eos_id or t == self.cfg.pad_id:
                break
            out.append(int(t))
        text = self.tokenizer.decode(out)
        eos = np.flatnonzero(toks == self.cfg.eos_id)
        self.stats["requests"] += 1
        self.stats["decode_steps"] += steps
        self.stats["tokens"] += int(eos[0]) + 1 if len(eos) else len(toks)

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
        """Capture the graphs of the (bucket, budget) grid: each bucket's
        prompt graph, and the decode graph of each budget's ceiling. Without
        it each key is captured by its first request. On the CPU there is
        nothing to capture."""
        if self.device.type == "cpu":
            return
        P = len(build_prompt(self.tokenizer, self.cfg).prefix_ids)
        with torch.inference_mode():
            for b in buckets or self.buckets:
                prompt = self.router.prepare(("prompt", b, P), self._prompt_fn,
                                             self._prompt_bufs(b, P)).outputs
                for ceiling in sorted({budget_ceiling(x) for x in budgets}):
                    d = self._decode_bufs(b, ceiling, P, prompt["k"].shape[2])
                    self.router.prepare(("decode", b, ceiling, DECODE_STEPS, P),
                                        self._decode_fn(DECODE_STEPS), d)
