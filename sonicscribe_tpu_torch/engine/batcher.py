"""Continuous batcher: packs concurrent sessions onto one card.

Port of the core of the JAX package's ``engine/batcher.py`` (no reference
counterpart; the reference serializes every session through one blocking
model call, backend/transcription_manager.py:58).

Design, as in JAX:

- TWO CACHE POOLS (`_CachePool`), each a fixed set of decode slots sharing
  one KV cache [L, rows, max_len, nkv, hd]: the SHORT pool (one slot per
  realtime stream, cache sized to the interim class) and the LONG pool
  (finals, file segments). Requests route by prompt + budget need. Row
  `n_slots` of each pool is its trash slot: padding rows of a batched
  prefill write there, and it stays done.
- PREFILL: one program per (pool, path, mel or chunk bucket, suffix
  bucket, batch size B) runs encoder + prompt assembly + prefill for B
  requests and writes each row's K/V, length, first token, budget and
  done flag into its slot.
- DECODE: one program per (pool, k, rows) runs k greedy steps for the
  pool's first `rows` slots (all of them for rows None) with per-slot
  logit bias; EOS and budget stops, emitted tokens and a status row are
  kept on the device.
- SPECULATIVE FINALS: a request may carry a draft (a session's banked
  interim tokens). While a drafted slot is live in the long pool, the
  pool runs the VERIFY program instead, one per (rounds, rows): each
  round feeds [last token, next w draft tokens] through verify_step (w+1
  query positions in one pass), accepts the longest draft prefix that
  greedy agrees with and emits it with greedy's correction, so a drafted
  slot emits up to w+1 tokens per pass and every slot emits exactly the
  greedy tokens. The acceptance EMA stops spending drafts that keep
  missing (spec_accept_min).
- EAGER-FINALS GATE: a session launches a speculative final at the first
  silent window only if ``eager_ok`` allows it (long-pool slack, live
  streams no more than long slots, no final backlog, at most half the
  pool speculative, interim admissions not queueing, and the bets'
  confirmation EMA, with a probe every 8th closed call); such an
  unconfirmed final does not escalate k in quiet windows unless that EMA
  is healthy.
- PIPELINED TICKS: each tick dispatches its programs, copies the status
  and token rows of each decode (and the VAD probabilities) to pinned host
  memory on the same stream right after it and records an event, then
  resolves the PREVIOUS tick's copies. Stream order keeps each copy ahead
  of the next tick's decode, which writes the same buffers in place.
  Parked results carry the slots' request identities, so a stale status
  never finishes a slot's next occupant.
- VAD: the gate windows of all streams are sliced from the device audio
  ring (engine/ring.py) and evaluated in one program per tick.

Programs are functions of one dict of static buffers, written in place:
each pool's state is the graphs' static memory, and admission copies a
request's inputs into static input buffers (never rebinding them). On the
card ``engine/exec_store.py``'s GraphRouter captures each program key as a
CUDA graph on first use (or in ``warmup``) and replays it; on the CPU
(``device="cpu"``, as the tests ask) the same programs run eagerly. All
device work runs on one executor thread; the event loop never touches the
device.

Not ported yet: the fused dual-pool decode, the stall watchdog and
crash self-heal, fast warmup, the data-parallel mesh.
"""

from __future__ import annotations

import asyncio
import functools
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from sonicscribe_tpu_torch.audio.mel import frame_count, log_mel_spectrogram
from sonicscribe_tpu_torch.engine.exec_store import GraphRouter
from sonicscribe_tpu_torch.engine.ring import (
    _SCATTER_BUCKETS,
    CHUNK_SAMPLES,
    RING_CHUNKS,
    make_vad_ring_program,
    ring_prompt_inputs,
    scatter_chunks_program,
)
from sonicscribe_tpu_torch.engine.transcriber import (
    MAX_SUFFIX_TOKENS,
    Transcriber,
    TranscribeResult,
)
from sonicscribe_tpu_torch.models.config import GlmAsrConfig
from sonicscribe_tpu_torch.models.glm_asr import (
    decode_step,
    embed_tokens,
    encode_audio,
    prefill_kv,
    verify_step,
)
from sonicscribe_tpu_torch.models.tokenizer import build_prompt
from sonicscribe_tpu_torch.vad.model import WINDOW_SAMPLES

logger = logging.getLogger(__name__)

_DECODE_K_CHOICES = (1, 2, 4, 8, 16, 32, 64)
# status-row flag of the verify program: a slot not done whose draft still
# has tokens to verify (far above any n_emitted + 1; never on negatives)
_SPEC_LIVE_FLAG = 1 << 16
# VAD batch ladder: one program per bucket
_VAD_BATCH_BUCKETS = (1, 4, 16, 64)
_GATE_WINDOW_CHUNKS = 10  # 640 ms
_GATE_SUB_WINDOWS = _GATE_WINDOW_CHUNKS * CHUNK_SAMPLES // WINDOW_SAMPLES


def _resolve_quietly(future: asyncio.Future, result) -> None:
    """set_result unless the client already cancelled."""
    if not future.done():
        future.set_result(result)


def _chunked(seq: list, cap: int) -> list[list]:
    """Split into bucket-capped chunks (a burst from more streams than the
    largest batch bucket spans several programs)."""
    return [seq[i : i + cap] for i in range(0, len(seq), cap)]


# =====================================================================
# programs: functions of a dict of static buffers, in place
# =====================================================================


def assemble_prompt_batch(params, cfg: GlmAsrConfig, mels, n_frames, prefix_ids, suffix_ids,
                          suffix_lens):
    """Batched prompt assembly: one encoder pass for B requests, each row's
    suffix placed at its true audio-token offset (a device tensor).
    mels [B, T, n_mels], n_frames [B], prefix_ids [P] (shared), suffix_ids
    [B, MS], suffix_lens [B] -> (embeddings [B, P + A + MS, D], totals [B])."""
    audio_embeds, n_toks = encode_audio(params, cfg, mels, n_frames)  # [B, A, D]
    B, A, D = audio_embeds.shape
    P, MS = prefix_ids.shape[0], suffix_ids.shape[1]
    buf = torch.zeros((B, P + A + MS, D), dtype=audio_embeds.dtype, device=mels.device)
    buf[:, :P] = embed_tokens(params, prefix_ids)[None]
    buf[:, P : P + A] = audio_embeds
    at = P + n_toks.long()[:, None] + torch.arange(MS, device=mels.device)[None, :]
    buf.scatter_(1, at[..., None].expand(B, MS, D), embed_tokens(params, suffix_ids))
    return buf, P + n_toks + suffix_lens


def _slot_write_program(bufs: dict) -> None:
    """The admit group's per-slot budgets and drafts (the JAX package's
    fused slot write): padding rows write a budget of 0 and an empty draft
    into the trash slot, which keeps it done."""
    slots = bufs["slots"]
    bufs["budget"].index_copy_(0, slots, bufs["budget_vals"])
    bufs["draft"].index_copy_(0, slots, bufs["draft_rows"])
    bufs["draft_len"].index_copy_(0, slots, bufs["draft_lens"])
    bufs["draft_pos"].index_fill_(0, slots, 0)


def _prefill_common(params, cfg: GlmAsrConfig, bufs: dict, mels, n_frames) -> None:
    """Batched encoder + prefill (the weights stream once for the group),
    then each row's K/V, length, first greedy token, emitted count and done
    flag into its slot."""
    _slot_write_program(bufs)
    buf, totals = assemble_prompt_batch(params, cfg, mels, n_frames, bufs["prefix_ids"],
                                        bufs["suffix_ids"], bufs["suffix_lens"])
    ks, vs, last_logits = prefill_kv(params, cfg, buf, totals)  # [L, B, Lb, nkv, hd]
    slots = bufs["slots"]
    B, Lb = ks.shape[1], ks.shape[2]
    tok0 = torch.argmax(last_logits + bufs["bias"][slots], dim=-1).to(torch.int32)
    bufs["k"][:, :, :Lb].index_copy_(1, slots, ks.to(bufs["k"].dtype))
    bufs["v"][:, :, :Lb].index_copy_(1, slots, vs.to(bufs["v"].dtype))
    bufs["len"].index_copy_(0, slots, totals.to(torch.int32))
    bufs["tok"].index_copy_(0, slots, tok0)
    first = torch.zeros((B, bufs["out"].shape[1]), dtype=torch.int32, device=tok0.device)
    first[:, 0] = tok0
    bufs["out"].index_copy_(0, slots, first)
    bufs["n"].index_copy_(0, slots, torch.ones_like(tok0))
    bufs["done"].index_copy_(0, slots, (tok0 == cfg.eos_id) | (bufs["budget"][slots] <= 1))


def _prefill_slots_program(params, cfg: GlmAsrConfig, bufs: dict) -> dict:
    """Admit B requests whose mel came from the host (the file path)."""
    _prefill_common(params, cfg, bufs, bufs["mels"], bufs["n_frames"])
    return {}


def _prefill_ring_program(params, cfg: GlmAsrConfig, mel_cfg, n_chunks: int,
                          bufs: dict) -> dict:
    """Admit B stream requests straight from the device audio ring: slice,
    peak-normalize, batched mel (one log-mel launch), encoder, prefill."""
    mels, n_frames = ring_prompt_inputs(bufs["ring"], mel_cfg, bufs["stream_idx"],
                                        bufs["start_chunk"], bufs["chunk_count"], n_chunks)
    _prefill_common(params, cfg, bufs, mels.to(bufs["k"].dtype), n_frames)
    return {}


def _book_step(cfg: GlmAsrConfig, logits, bias, dn, tok, out, n, bud, max_new: int):
    """One step's bookkeeping (the JAX batcher's rules): greedy pick with
    bias; a done (frozen) slot keeps its token and writes nothing; the pick
    is written at the emitted count; done is set after the pick, on EOS or
    once the count reaches the budget. `out` in place; -> (tok, n, done)."""
    nxt = torch.argmax(logits + bias, dim=-1).to(torch.int32)
    nxt = torch.where(dn, tok, nxt)
    pos = torch.clamp(n, max=max_new - 1).long()[:, None]
    out.scatter_(1, pos, torch.where(dn[:, None], out.gather(1, pos), nxt[:, None]))
    n = torch.where(dn, n, n + 1)
    dn = dn | (nxt == cfg.eos_id) | (n >= bud)
    return nxt, n, dn


def _decode_k_program(params, cfg: GlmAsrConfig, bufs: dict, k: int,
                      rows: Optional[int] = None) -> dict:
    """k greedy steps for the pool's first `rows` slots (all for None), in
    place; then the status row over every slot: n_emitted + 1, negative
    once done. Slots are allocated lowest first, so the active ones sit in
    a prefix and the smaller rows read proportionally less cache; the rows
    past it are untouched. Each layer's cache view [:rows] is contiguous."""
    S, max_new = bufs["out"].shape
    R = S if rows is None else min(rows, S)
    cache = {"k": bufs["k"][:, :R], "v": bufs["v"][:, :R], "len": bufs["len"][:R]}
    tok, n, dn = bufs["tok"][:R], bufs["n"][:R], bufs["done"][:R]
    bias, bud, out = bufs["bias"][:R], bufs["budget"][:R], bufs["out"][:R]
    for _ in range(k):
        _, logits = decode_step(params, cfg, cache, tok, active=~dn)
        nxt, n_new, dn_new = _book_step(cfg, logits, bias, dn, tok, out, n, bud, max_new)
        tok.copy_(nxt)
        n.copy_(n_new)
        dn.copy_(dn_new)
    n_all = bufs["n"]
    bufs["status"].copy_(torch.where(bufs["done"], -(n_all + 1), n_all + 1))
    return {}


def _verify_rounds_program(params, cfg: GlmAsrConfig, bufs: dict, w: int, n_rounds: int,
                           rows: Optional[int] = None) -> dict:
    """n_rounds speculative verification rounds for the pool's first `rows`
    slots (all for None), in place (the JAX package's
    _verify_rounds_program). Each round, per slot: [tok, the next w draft
    tokens] through verify_step, the greedy pick g_j (with bias) at every
    position, the longest prefix where draft d_j == g_j accepted (a), and
    d_0..d_{a-1} plus g_a emitted: the tokens sequential greedy decode
    emits. The first emitted EOS and the budget cut the emission; len, tok,
    n and done advance by it. The draft cursor moves past the draft tokens
    greedy agreed with, in order: the a accepted ones and, when all w were,
    the draft's next token d_w where it equals the emitted g_w (it predicted
    that very token); on a mismatch it moves to the draft's end. (The JAX
    program advances it by a alone, so after a round that accepts all w
    the next one tests d_w against the token after g_w, and a draft that
    is right throughout dies in its second round.) A slot without a draft
    emits one token a round. Then the status row over every slot, as the
    decode program's, plus _SPEC_LIVE_FLAG on a slot not done whose draft
    has tokens left. All on the device: no host sync, one CUDA graph."""
    S, max_new = bufs["out"].shape
    R = S if rows is None else min(rows, S)
    max_draft = bufs["draft"].shape[1]
    dev = bufs["tok"].device
    j_idx = torch.arange(w + 1, device=dev)
    out_pos = torch.arange(max_new, device=dev)
    cache = {"k": bufs["k"][:, :R], "v": bufs["v"][:, :R], "len": bufs["len"][:R]}
    tok, n, dn, dpos = bufs["tok"][:R], bufs["n"][:R], bufs["done"][:R], bufs["draft_pos"][:R]
    bias, bud, out = bufs["bias"][:R], bufs["budget"][:R], bufs["out"][:R]
    draft, dlen = bufs["draft"][:R], bufs["draft_len"][:R]
    for _ in range(n_rounds):
        # the next w + 1 draft tokens: the round's w inputs and the one after
        idx = dpos[:, None] + j_idx[None, :]
        have = idx < dlen[:, None]
        dnext = torch.where(have, draft.gather(1, torch.clamp(idx, 0, max_draft - 1).long()),
                            cfg.pad_id)
        dtoks = dnext[:, :w]
        _, logits = verify_step(params, cfg, cache, torch.cat([tok[:, None], dtoks], dim=1))
        g = torch.argmax(logits + bias[:, None, :], dim=-1).to(torch.int32)  # [R, w+1]
        # draft tokens greedy agrees with, in order (c), and the accepted
        # inputs among them (a)
        c = torch.cumprod((have & (dnext == g)).to(torch.int32), dim=1).sum(dim=1)
        c = c.to(torch.int32)
        a = torch.clamp(c, max=w)
        # candidates e_0..e_a: the draft below a, greedy's correction at a
        e = torch.where(j_idx[None, :] < a[:, None], torch.cat([dtoks, dtoks[:, -1:]], dim=1), g)
        eos_at = (e == cfg.eos_id) & (j_idx[None, :] <= a[:, None])
        first_eos = torch.argmax(eos_at.to(torch.int32), dim=1)  # the first, as JAX's
        m = torch.where(eos_at.any(dim=1), first_eos + 1, a + 1)
        m = torch.minimum(m, torch.clamp(bud - n, min=0))
        m = torch.where(dn, 0, m).to(torch.int32)
        # e_0..e_{m-1} into out at n..n+m-1; each column written once (the
        # JAX program's clamped scatter repeats the last column's index)
        rel = out_pos[None, :] - n[:, None].long()
        take = (rel >= 0) & (rel < m[:, None])
        out.copy_(torch.where(take, e.gather(1, torch.clamp(rel, 0, w)), out))
        kept_eos = (eos_at & (j_idx[None, :] < m[:, None])).any(dim=1)
        n_new = n + m
        dn_new = dn | kept_eos | (n_new >= bud)
        # the emitted inputs' K/V are in the cache; the last emitted token is
        # the next round's x_0, as in decode_step
        cache["len"].copy_(cache["len"] + m)
        tok.copy_(torch.where(m > 0, e.gather(1, torch.clamp(m - 1, min=0).long()[:, None])[:, 0],
                              tok))
        avail = torch.clamp(torch.clamp(dlen - dpos, max=w + 1), min=0)
        diverged = (c < avail) & ~dn
        dpos.copy_(torch.where(diverged, dlen, dpos + c))
        n.copy_(n_new)
        dn.copy_(dn_new)
    n_all, done_all = bufs["n"], bufs["done"]
    live = ~done_all & (bufs["draft_pos"] < bufs["draft_len"])
    bufs["status"].copy_(torch.where(done_all, -(n_all + 1),
                                     n_all + 1 + torch.where(live, _SPEC_LIVE_FLAG, 0)))
    return {}


def _make_vad_batch_program(vad, n_sub: int):
    """Host-audio gate windows: bufs windows [B, n_sub, 512] and states
    {field: [B]} -> max probability over the sub-windows per row into
    probs, the states after them in place."""

    def program(bufs: dict) -> dict:
        states = dict(bufs["states"])
        windows = bufs["windows"]
        best = torch.zeros((windows.shape[0],), dtype=torch.float32, device=windows.device)
        for i in range(n_sub):
            probs, states = vad.forward(vad.params, windows[:, i], states)
            best = torch.maximum(best, probs)
        for name, t in bufs["states"].items():
            t.copy_(states[name])
        bufs["probs"].copy_(best)
        return {}

    return program


# =====================================================================
# engine
# =====================================================================


@dataclass
class _SlotState:
    request: Any = None
    budget: int = 0
    active: bool = False
    steps_seen: int = 0  # decode steps dispatched while this slot was active
    drafted: bool = False  # admitted with a draft it spends (the verify path)
    # verify rounds the draft can still use: ceil(draft_len / w) at admit,
    # less the rounds dispatched (the status flag arrives a tick late)
    spec_rounds: int = 0


@dataclass
class _CachePool:
    """One decode class: its KV cache, slots and state, the static memory of
    its programs. `state` holds k, v [L, rows, max_len, nkv, hd]; len, tok,
    n, budget, status [rows] int32; done [rows] bool; out [rows, out_width]
    int32; bias [rows, V] float32; the drafts: draft [rows, out_width]
    int32, draft_pos, draft_len [rows] int32. Row `trash_slot` (==
    n_slots) takes the padding rows of batched prefills."""

    name: str
    max_len: int
    trash_slot: int
    state: dict
    # occupied-prefix decode ladder: row counts captured besides the full
    # pool (long pool only)
    rows_ladder: tuple = ()
    bias_dirty: list = field(default_factory=list)
    slots: list = field(default_factory=list)
    # the program grid warmup registered: admission uses only these batch
    # sizes, and _pick_rows only these (k, rows)
    compiled_prefill: set = field(default_factory=set)
    compiled_ring_prefill: set = field(default_factory=set)
    compiled_decode: set = field(default_factory=set)
    compiled_verify: set = field(default_factory=set)  # (rounds, rows)

    @property
    def n_active(self) -> int:
        return sum(s.active for s in self.slots)

    @property
    def free(self) -> int:
        return len(self.slots) - self.n_active


@dataclass
class _TranscribeReq:
    audio: np.ndarray
    sample_rate: int
    max_new_tokens: int
    hotwords: Optional[list[str]]
    future: asyncio.Future
    t_enqueue: float
    # resolved-pool hint: set when prep finds that the true mel bucket routes
    # elsewhere than the pre-resample estimate (no re-route bounce loop)
    pool_hint: Any = None
    t_admit: float = 0.0
    # the session's predicted tokens (its banked interims): verified, never trusted
    draft_tokens: Any = None
    # an unconfirmed eager final: no k-escalation for it unless the bets'
    # confirmation EMA is healthy; confirm_speculative clears it
    speculative: bool = False


@dataclass
class _VadReq:
    audio: np.ndarray
    state: Any
    future: asyncio.Future


@dataclass
class _VadRingReq:
    stream_idx: int
    start_chunk: int
    future: asyncio.Future


@dataclass
class _RingTranscribeReq:
    stream_idx: int
    start_chunk: int
    chunk_count: int
    max_new_tokens: int
    hotwords: Optional[list[str]]
    duration_s: float
    future: asyncio.Future
    t_enqueue: float
    t_admit: float = 0.0
    draft_tokens: Any = None  # as in _TranscribeReq
    speculative: bool = False


class BatchedEngine:
    """Continuous-batching engine; the interface of ThreadedEngine plus the
    device audio ring of realtime streams (``has_ring``)."""

    has_ring = True

    def __init__(
        self,
        transcriber: Transcriber,
        vad,
        slots: int = 8,
        max_decode_tokens: int = 256,
        n_streams: int = 64,
        base_logit_bias=None,
    ):
        self.transcriber = transcriber
        self.vad = vad
        self.cfg = transcriber.cfg
        self.MAX_NEW = max_decode_tokens
        self.device = transcriber.device
        dtype = transcriber.dtype
        dec = self.cfg.decoder
        max_audio_tokens = max(transcriber.buckets) // self.cfg.frames_per_audio_token
        self.max_prompt = 3 + max_audio_tokens + MAX_SUFFIX_TOKENS
        long_max_len = self.max_prompt + max_decode_tokens
        # base additive logit bias of every slot (hotword rows add to it)
        self._base_bias = torch.zeros((dec.vocab_size,), dtype=torch.float32, device=self.device)
        if base_logit_bias is not None:
            self._base_bias.copy_(torch.as_tensor(np.asarray(base_logit_bias, np.float32)))
        self.router = GraphRouter(self.device)

        def make_pool(name: str, n_slots: int, max_len: int, out_width: int) -> _CachePool:
            rows, dev, i32 = n_slots + 1, self.device, torch.int32
            shape = (dec.n_layers, rows, max_len, dec.n_kv_heads, dec.head_dim)
            state = {
                "k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "len": torch.zeros((rows,), dtype=i32, device=dev),
                "tok": torch.zeros((rows,), dtype=i32, device=dev),
                "out": torch.zeros((rows, out_width), dtype=i32, device=dev),
                "n": torch.zeros((rows,), dtype=i32, device=dev),
                "done": torch.ones((rows,), dtype=torch.bool, device=dev),
                "bias": self._base_bias[None].repeat(rows, 1),
                "budget": torch.zeros((rows,), dtype=i32, device=dev),
                "status": torch.zeros((rows,), dtype=i32, device=dev),
                "draft": torch.full((rows, max(out_width, 1)), self.cfg.pad_id, dtype=i32,
                                    device=dev),
                "draft_pos": torch.zeros((rows,), dtype=i32, device=dev),
                "draft_len": torch.zeros((rows,), dtype=i32, device=dev),
            }
            return _CachePool(name=name, max_len=max_len, trash_slot=n_slots, state=state,
                              bias_dirty=[False] * rows,
                              slots=[_SlotState() for _ in range(n_slots)])

        # suffix buckets: the default instruction gets a tight bucket, hotword
        # prompts the MAX_SUFFIX_TOKENS one
        base_suffix = len(build_prompt(transcriber.tokenizer, self.cfg).suffix_ids)
        sb0 = min(MAX_SUFFIX_TOKENS, ((base_suffix + 2 + 7) // 8) * 8)
        self.suffix_buckets = (sb0, MAX_SUFFIX_TOKENS) if sb0 < MAX_SUFFIX_TOKENS else (sb0,)

        # short pool: the interim class (smallest mel bucket, default suffix
        # bucket, a small budget), one slot per realtime stream
        self.short_budget = min(16, max_decode_tokens)
        smallest_prompt = (3 + min(transcriber.buckets) // self.cfg.frames_per_audio_token
                           + self.suffix_buckets[0])
        self.long = make_pool("long", slots, long_max_len, max_decode_tokens)
        self.short = make_pool("short", n_streams, smallest_prompt + self.short_budget,
                               self.short_budget)
        # occupied-prefix decode: rungs 1/4/16 of the long pool
        self.long.rows_ladder = tuple(r for r in (1, 4, 16) if r < len(self.long.slots) + 1)
        self.pools = (self.short, self.long)
        # the short pool's k ladder stops below twice its budget, and holds
        # short_budget - 1 (a fresh interim's remaining steps)
        self.dual_k_choices = tuple(sorted(
            {c for c in _DECODE_K_CHOICES if c < 2 * max(self.short_budget, 1)}
            | {max(1, self.short_budget - 1)}
        ))
        self.prefill_batch_choices = tuple(
            b for b in (1, 2, 4, 8, 16, 32) if b <= max(1, slots, n_streams)
        )

        self._requests: asyncio.Queue = asyncio.Queue()
        self._vad_requests: asyncio.Queue = asyncio.Queue()
        self._wake = asyncio.Event()

        # ---- device audio ring (realtime streams; engine/ring.py) ----
        self.N_STREAMS = n_streams
        self.trash_stream = n_streams
        self.ring = torch.zeros((n_streams + 1, 2 * RING_CHUNKS, CHUNK_SAMPLES),
                                dtype=torch.int16, device=self.device)
        self._free_streams = list(range(n_streams))
        # per-stream VAD state, one trash row for padding rows' writes
        self.vad_states = vad.init_state(n_streams + 1)
        self._stream_resets: list[int] = []
        self._vad_ring_program = make_vad_ring_program(vad, _GATE_WINDOW_CHUNKS)
        self._vad_programs: dict = {}  # n_sub -> host VAD program
        self._ingest_pending: list[tuple[int, int, np.ndarray]] = []
        self._vad_ring_requests: asyncio.Queue = asyncio.Queue()
        self._ring_requests: asyncio.Queue = asyncio.Queue()
        # chunk buckets: frame buckets are multiples of 128 frames = 20 chunks
        self.chunk_buckets = sorted(b * 160 // CHUNK_SAMPLES for b in transcriber.buckets)

        self._bufs: dict = {}  # static input buffers by program key
        self._executor: Optional[ThreadPoolExecutor] = None
        self._task: Optional[asyncio.Task] = None
        self._loop = None
        self._running = False
        self._crashed = False  # set only by the scheduler's crash handler
        self._pending_results: Optional[dict] = None  # the previous tick's parked copies
        self._ring_backlog: list[_RingTranscribeReq] = []
        self._host_backlog: list[_TranscribeReq] = []
        # True while a backlogged request routes to the short pool
        self._backlog_has_short = False
        # decode_steps: k of every pool's decode dispatch; tokens: emitted up to
        # the budget or EOS (EOS included); mel_preps: host requests whose
        # mel was made (one log-mel launch each)
        # steps of the verify program (verify_rounds is a part of decode_steps);
        # eager_granted / eager_denied: eager_ok's answers
        self.stats = {"ticks": 0, "decode_steps": 0, "prefills": 0, "prefill_programs": 0,
                      "ring_prefill_programs": 0, "mel_preps": 0, "vad_batches": 0,
                      "requests": 0, "tokens": 0, "verify_rounds": 0, "eager_granted": 0,
                      "eager_denied": 0}
        # decode-k caps (the JAX package's values, tuned there on the chip):
        # an arrival mid-program waits for it, so these bound queueing
        self.pending_k_cap = 16
        self.live_k_cap = 32
        self.long_live_k_cap = 8  # long pool while realtime streams are live
        self.long_oversub_k_cap = 16  # ...live streams outnumber long slots
        self.long_idle_k_cap = 32  # ...the short class quiet
        self.short_quiet_s = 0.3
        self._last_short_admit = 0.0
        # interim admission wait (EMA, ms); the oversubscribed long cap and
        # the eager-finals gate apply only while it is under budget. It
        # starts above: speculation must first see slack
        self.short_queue_ema = 150.0
        self.short_queue_budget_ms = 75.0
        # speculative finals (the JAX package's values): w draft tokens a
        # verify round, the rounds a verify program may run; drafts are
        # spent only while the acceptance EMA (matching-prefix share of a
        # finished drafted request's draft) is at the floor or above, and
        # it is measured against the output either way, so it recovers
        self.speculative = True
        self.spec_w = 8
        self.verify_rounds_choices = (1, 2, 4, 8)
        self.spec_accept_ema = 1.0
        self.spec_accept_min = 0.35
        # eager finals: the bets' confirmation EMA, folded at most once per
        # eager_window_s (a lockstep wave of outcomes is one observation;
        # 0 folds each outcome)
        self.eager_accept_ema = 1.0
        self.eager_accept_min = 0.5
        self.eager_window_s = 0.64
        self._eager_pending: list[bool] = []
        self._eager_fold_t = time.perf_counter()
        self._eager_probe = 0
        # long admissions per tick while the short class is busy
        self.busy_long_admit_cap = 2
        # the file pipeline may run this many segment decodes at once
        self.concurrency_hint = slots
        # total mel frames of a long-pool prefill group while the short class
        # is active, and while it is quiet
        self.live_busy_prefill_frame_cap = 512
        self.quiet_prefill_frame_cap = 2048

    @property
    def alive(self) -> bool:
        """False once the scheduler has crashed; True before the first start
        and after a graceful shutdown."""
        return not self._crashed

    # ---------------- public async interface ----------------

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        if self._task is not None and (self._task.done() or self._loop is not loop):
            if not self._task.done():
                try:
                    self._task.cancel()
                except RuntimeError:
                    pass  # the old loop is closed
            self._task = None
        if self._task is None:
            self._crashed = False
            self._loop = loop
            if self._executor is None:
                self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="batcher")
            self._requests = asyncio.Queue()
            self._vad_requests = asyncio.Queue()
            self._vad_ring_requests = asyncio.Queue()
            self._ring_requests = asyncio.Queue()
            self._wake = asyncio.Event()
            self._pending_results = None
            self._running = True
            self._task = asyncio.ensure_future(self._scheduler())

    async def transcribe(self, audio: np.ndarray, sample_rate: int, max_new_tokens: int,
                         hotwords: Optional[list[str]] = None, draft_tokens=None,
                         speculative: bool = False) -> TranscribeResult:
        """Transcribe host audio. draft_tokens: predicted tokens (its first
        the prediction of the prefill's token), verified on the long pool:
        the output is the greedy one whatever they hold. speculative: an
        unconfirmed eager final (see confirm_speculative)."""
        await self.start()
        fut = asyncio.get_running_loop().create_future()
        await self._requests.put(_TranscribeReq(
            np.asarray(audio, np.float32), sample_rate, min(max_new_tokens, self.MAX_NEW),
            hotwords, fut, time.perf_counter(), draft_tokens=draft_tokens,
            speculative=speculative))
        self._wake.set()
        return await fut

    async def vad_window_prob(self, audio: np.ndarray, state):
        """(max speech probability over the window's 512-sample sub-windows,
        the stream's VAD state after them, on the CPU); state None: a fresh
        stream."""
        await self.start()
        fut = asyncio.get_running_loop().create_future()
        await self._vad_requests.put(_VadReq(np.asarray(audio, np.float32), state, fut))
        self._wake.set()
        return await fut

    # ---------------- device audio-ring interface (realtime streams) ----

    def alloc_stream(self) -> Optional[int]:
        """Claim a ring stream row; None at capacity. Its VAD state row is
        reset by the next tick, before any of its chunks is read."""
        if not self._free_streams:
            return None
        idx = self._free_streams.pop()
        self._stream_resets.append(idx)
        return idx

    def free_stream(self, idx: int) -> None:
        if idx is not None and idx not in self._free_streams:
            self._free_streams.append(idx)

    def interim_stagger(self, stream_idx: Optional[int]) -> float:
        """Per-stream interim-cadence phase in seconds, read by the session
        at each speech start: 0 unless the live streams could fill half the
        short pool in one wave, then (idx % 8) / 8, so that lockstep cohorts
        spread over eight phases."""
        live = self.N_STREAMS - len(self._free_streams)
        if stream_idx is None or live * 2 < len(self.short.slots):
            return 0.0
        return (stream_idx % 8) / 8.0

    def ingest(self, stream_idx: int, chunk_id: int, pcm: bytes) -> None:
        """Queue one 64 ms int16 chunk for the next packed upload (no device
        work here)."""
        arr = np.frombuffer(pcm[:2048], dtype="<i2")
        if arr.shape[0] < CHUNK_SAMPLES:
            arr = np.pad(arr, (0, CHUNK_SAMPLES - arr.shape[0]))
        self._ingest_pending.append((stream_idx, chunk_id, arr))
        try:
            self._wake.set()
        except RuntimeError:
            pass  # _wake bound to a closed loop; the next call rebinds it

    async def vad_window_ring(self, stream_idx: int, start_chunk: int) -> float:
        """Gate probability of the 10-chunk window at start_chunk, sliced
        from the ring; the stream's state stays on the device."""
        await self.start()
        fut = asyncio.get_running_loop().create_future()
        await self._vad_ring_requests.put(_VadRingReq(stream_idx, start_chunk, fut))
        self._wake.set()
        return await fut

    async def transcribe_ring(self, stream_idx: int, start_chunk: int, chunk_count: int,
                              max_new_tokens: int, hotwords: Optional[list[str]] = None,
                              duration_s: float = 0.0, draft_tokens=None,
                              speculative: bool = False) -> TranscribeResult:
        """Transcribe ring chunks [start_chunk, start_chunk + chunk_count):
        no audio upload. draft_tokens, speculative: as in transcribe."""
        await self.start()
        fut = asyncio.get_running_loop().create_future()
        await self._ring_requests.put(_RingTranscribeReq(
            stream_idx, start_chunk, chunk_count, min(max_new_tokens, self.MAX_NEW), hotwords,
            duration_s or chunk_count * CHUNK_SAMPLES / 16000.0, fut, time.perf_counter(),
            draft_tokens=draft_tokens, speculative=speculative))
        self._wake.set()
        return await fut

    def shutdown(self) -> None:
        self._running = False
        task, self._task = self._task, None
        if task is None or task.done():
            return
        loop = task.get_loop()
        if loop.is_closed():
            return
        # let the scheduler see _running False and exit; cancel if it cannot
        self._wake.set()
        if not loop.is_running():
            try:
                loop.run_until_complete(asyncio.wait_for(task, timeout=2.0))
            except Exception:
                task.cancel()
            executor, self._executor = self._executor, None
            if executor is not None:
                executor.shutdown(wait=False)
        else:
            loop.call_later(2.0, task.cancel)

    # ---------------- the program grid ----------------

    def _prompt_defaults(self):
        prompt = build_prompt(self.transcriber.tokenizer, self.cfg)
        return prompt, min(len(prompt.suffix_ids), MAX_SUFFIX_TOKENS)

    def _grid(self) -> dict:
        """The default program grid, as the JAX package's warmup picks it:
        {"host" | "ring": [(pool, bucket, sb, B)], "decode" | "verify":
        [(pool, k or rounds, rows)]}. Short pool: every batch size for the
        interim ring path at the smallest chunk bucket, (1, 4) host and 1
        elsewhere; long pool: a group ladder (1, 2, 4, 8 as the live frame
        cap allows, and 4 and 8) for the default suffix bucket, 1 for
        hotword prompts; decode every k of the pool's ladder, rows variants
        for k >= 8; with speculative finals, verify every rounds choice on
        the full pool and rows 1 and 4 (long pool only: finals are what
        carry drafts, and a drafted short request takes the plain ladder)."""
        tr = self.transcriber
        smallest, smallest_cb = min(tr.buckets), min(self.chunk_buckets)
        grid = {"host": [], "ring": [], "decode": [], "verify": []}

        def choices(pool, ring: bool, is_smallest: bool, sb: int, frame_bucket: int, pc):
            if pool is self.short:
                if ring and is_smallest:
                    return pc
                return tuple(b for b in ((1, 4) if not ring else (1,)) if b in pc) or (1,)
            if sb == self.suffix_buckets[0]:
                live_cap = max(1, self.live_busy_prefill_frame_cap // max(frame_bucket, 1))
                return tuple(b for b in (1, 2, 4, 8)
                             if b in pc and (b <= live_cap or b in (4, 8))) or (1,)
            return (1,)

        for pool in self.pools:
            pc = tuple(b for b in self.prefill_batch_choices if b <= max(1, len(pool.slots)))
            for path, buckets in (("host", tr.buckets), ("ring", self.chunk_buckets)):
                for bucket in buckets:
                    fb = bucket if path == "host" else bucket * CHUNK_SAMPLES // 160
                    is_smallest = bucket == (smallest if path == "host" else smallest_cb)
                    for sb in self.suffix_buckets:
                        if pool is self.short and self._pool_for(fb, 1, sb) is not pool:
                            continue  # the short pool hosts only what fits it
                        for B in choices(pool, path == "ring", is_smallest, sb, fb, pc):
                            grid[path].append((pool, bucket, sb, B))
            for k in (self.dual_k_choices if pool is self.short else _DECODE_K_CHOICES):
                for rows in (None,) + tuple(r for r in pool.rows_ladder if k >= 8):
                    grid["decode"].append((pool, k, rows))
            if self.speculative and pool is self.long:
                for r in self.verify_rounds_choices:
                    for rows in (None,) + tuple(rw for rw in pool.rows_ladder if rw in (1, 4)):
                        grid["verify"].append((pool, r, rows))
        return grid

    def warmup(self, budgets=(15, 200, 256)) -> dict:
        """Register the default program grid (`_grid`) for both pools and,
        on the card, capture each of its CUDA graphs synchronously, with the
        VAD and scatter programs; then one admit -> decode -> reap per pool.
        Without it (--no-warmup) prefill groups admit at B = 1 and each key
        is captured by its first use. On the CPU nothing is captured: the
        grid is only registered. -> {"graphs", "seconds"}."""
        del budgets  # a decode program serves every budget
        t0 = time.perf_counter()
        grid = self._grid()
        cuda = self.device.type == "cuda"
        prompt, n_suffix = self._prompt_defaults()
        P = len(prompt.prefix_ids)
        with torch.inference_mode():
            for pool, bucket, sb, B in grid["host"]:
                if cuda:
                    key, fn, bufs = self._prefill_entry(pool, False, bucket, sb, B, P)
                    self.router.prepare(key, fn, bufs)
                pool.compiled_prefill.add((bucket, sb, B))
            for pool, cb, sb, B in grid["ring"]:
                if cuda:
                    key, fn, bufs = self._prefill_entry(pool, True, cb, sb, B, P)
                    self.router.prepare(key, fn, bufs)
                pool.compiled_ring_prefill.add((cb, sb, B))
            for pool, k, rows in grid["decode"]:
                if cuda:
                    self.router.prepare(("decode", pool.name, k, rows), self._decode_fn(k, rows),
                                        pool.state)
                pool.compiled_decode.add((k, rows))
            for pool, r, rows in grid["verify"]:
                if cuda:
                    self.router.prepare(self._verify_key(pool, r, rows),
                                        self._verify_fn(r, rows), pool.state)
                pool.compiled_verify.add((r, rows))
            if cuda:
                for B in _VAD_BATCH_BUCKETS:
                    self.router.prepare(*self._vad_host_entry(B, _GATE_SUB_WINDOWS))
                    self.router.prepare(*self._vad_ring_entry(B))
                for M in _SCATTER_BUCKETS:
                    self.router.prepare(*self._scatter_entry(M))
                for pool in self.pools:
                    self._exercise(pool, prompt, n_suffix)
                torch.cuda.synchronize(self.device)
        out = {"graphs": self.router.stats["graphs"], "seconds": time.perf_counter() - t0}
        self.stats["warmup_graphs"] = out["graphs"]
        self.stats["warmup_s"] = round(out["seconds"], 1)
        return out

    def _exercise(self, pool: _CachePool, prompt, n_suffix: int) -> None:
        """One real admit -> decode -> reap into slot 0 from the trash
        stream (the warmup's end-to-end run), then the slot reset."""
        sb, cb = self.suffix_buckets[0], min(self.chunk_buckets)
        key, fn, bufs = self._prefill_entry(pool, True, cb, sb, 1, len(prompt.prefix_ids))
        suffix = np.full((1, sb), self.cfg.pad_id, np.int32)
        suffix[0, : min(n_suffix, sb)] = prompt.suffix_ids[: min(n_suffix, sb)]
        self._put_all(bufs, stream_idx=[self.trash_stream], start_chunk=[0], chunk_count=[1],
                      suffix_ids=suffix, suffix_lens=[min(n_suffix, sb)], slots=[0],
                      budget_vals=[3], draft_lens=[0])
        self.router.run(key, fn, bufs)
        self.router.run(("decode", pool.name, 4, None), self._decode_fn(4, None), pool.state)
        self._to_host(pool.state["out"])
        st = pool.state
        st["len"].zero_()
        st["n"].zero_()
        st["done"].fill_(True)
        st["budget"].zero_()

    def _prefill_entry(self, pool: _CachePool, ring: bool, bucket: int, sb: int, B: int, P: int):
        """(key, program, static buffers) of a prefill program: the pool's
        state and the group's inputs, made once per key in a state the
        program can run on (every row padding aimed at the trash slot)."""
        key = ("ring_prefill" if ring else "prefill", pool.name, bucket, B, sb, P)
        tr, cfg = self.transcriber, self.cfg
        if key not in self._bufs:
            dev, i32 = self.device, torch.int32
            prompt, n_suffix = self._prompt_defaults()
            inputs = {
                "prefix_ids": torch.as_tensor(np.asarray(prompt.prefix_ids, np.int32)[:P],
                                              device=dev),
                "suffix_ids": torch.full((B, sb), cfg.pad_id, dtype=i32, device=dev),
                "suffix_lens": torch.full((B,), min(n_suffix, sb), dtype=i32, device=dev),
                "slots": torch.full((B,), pool.trash_slot, dtype=torch.long, device=dev),
                "budget_vals": torch.zeros((B,), dtype=i32, device=dev),
                "draft_rows": torch.full((B, pool.state["draft"].shape[1]), cfg.pad_id,
                                         dtype=i32, device=dev),
                "draft_lens": torch.zeros((B,), dtype=i32, device=dev),
            }
            if ring:
                inputs.update(
                    ring=self.ring,
                    stream_idx=torch.full((B,), self.trash_stream, dtype=i32, device=dev),
                    start_chunk=torch.zeros((B,), dtype=i32, device=dev),
                    chunk_count=torch.ones((B,), dtype=i32, device=dev))
            else:
                inputs.update(
                    mels=torch.zeros((B, bucket, tr.mel_cfg.n_mels), dtype=tr.dtype, device=dev),
                    n_frames=torch.full((B,), bucket, dtype=i32, device=dev))
            self._bufs[key] = {**pool.state, **inputs}
        if ring:
            fn = functools.partial(_prefill_ring_program, tr.params, cfg, tr.mel_cfg, bucket)
        else:
            fn = functools.partial(_prefill_slots_program, tr.params, cfg)
        return key, fn, self._bufs[key]

    def _decode_fn(self, k: int, rows: Optional[int]):
        return functools.partial(_decode_k_program, self.transcriber.params, self.cfg, k=k,
                                 rows=rows)

    def _verify_key(self, pool: _CachePool, rounds: int, rows: Optional[int]) -> tuple:
        return ("verify", pool.name, self.spec_w, rounds, rows)

    def _verify_fn(self, rounds: int, rows: Optional[int]):
        return functools.partial(_verify_rounds_program, self.transcriber.params, self.cfg,
                                 w=self.spec_w, n_rounds=rounds, rows=rows)

    def _vad_host_entry(self, B: int, n_sub: int):
        key = ("vad_host", B, n_sub)
        if key not in self._bufs:
            dev = self.device
            self._bufs[key] = {
                "windows": torch.zeros((B, n_sub, WINDOW_SAMPLES), dtype=torch.float32,
                                       device=dev),
                "states": self.vad.init_state(B),
                "probs": torch.zeros((B,), dtype=torch.float32, device=dev),
            }
        if n_sub not in self._vad_programs:
            self._vad_programs[n_sub] = _make_vad_batch_program(self.vad, n_sub)
        return key, self._vad_programs[n_sub], self._bufs[key]

    def _vad_ring_entry(self, B: int):
        key = ("vad_ring", B)
        if key not in self._bufs:
            dev = self.device
            self._bufs[key] = {
                "ring": self.ring, "states": self.vad_states,
                "stream_idx": torch.zeros((B,), dtype=torch.int32, device=dev),
                "start_chunk": torch.zeros((B,), dtype=torch.int32, device=dev),
                "active": torch.zeros((B,), dtype=torch.bool, device=dev),
                "probs": torch.zeros((B,), dtype=torch.float32, device=dev),
            }
        return key, self._vad_ring_program, self._bufs[key]

    def _scatter_entry(self, M: int):
        key = ("scatter", M)
        if key not in self._bufs:
            dev = self.device
            self._bufs[key] = {
                "ring": self.ring,
                "packed": torch.zeros((M, CHUNK_SAMPLES), dtype=torch.int16, device=dev),
                "stream_idx": torch.full((M,), self.trash_stream, dtype=torch.int32, device=dev),
                "chunk_ids": torch.zeros((M,), dtype=torch.int32, device=dev),
            }
        return key, scatter_chunks_program, self._bufs[key]

    # ---------------- host <-> device copies (never a stream sync) --------

    def _put_all(self, bufs: dict, **arrays) -> None:
        """Copy host arrays into static buffers of the same name: through
        pinned memory on the card (no wait for the stream), in place."""
        for name, arr in arrays.items():
            dst = bufs[name]
            src = torch.from_numpy(np.ascontiguousarray(np.asarray(arr))).to(dst.dtype)
            if self.device.type == "cuda":
                src = src.pin_memory()
            dst.copy_(src.reshape(dst.shape), non_blocking=True)

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of t, enqueued on the current stream (pinned on the
        card: ready once an event recorded after it has passed)."""
        if self.device.type != "cuda":
            return t.clone()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    def _event(self):
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    # ---------------- routing ----------------

    def _suffix_bucket(self, n_suffix: int) -> int:
        for sb in self.suffix_buckets:
            if n_suffix <= sb:
                return sb
        return self.suffix_buckets[-1]

    def _prompt_len(self, frame_bucket: int, suffix_bucket: Optional[int] = None) -> int:
        return (3 + frame_bucket // self.cfg.frames_per_audio_token
                + (self.suffix_buckets[0] if suffix_bucket is None else suffix_bucket))

    def _pool_for(self, frame_bucket: int, budget: int,
                  suffix_bucket: Optional[int] = None) -> _CachePool:
        """The smallest pool whose cache fits the prompt and the budget."""
        need = self._prompt_len(frame_bucket, suffix_bucket) + budget
        if need <= self.short.max_len and self.short.slots:
            return self.short
        return self.long

    def _req_suffix_bucket(self, req) -> int:
        """The request's suffix bucket, memoized on it."""
        sb = getattr(req, "_suffix_bucket_memo", None)
        if sb is None:
            prompt = build_prompt(self.transcriber.tokenizer, self.cfg, hotwords=req.hotwords)
            sb = self._suffix_bucket(min(len(prompt.suffix_ids), MAX_SUFFIX_TOKENS))
            req._suffix_bucket_memo = sb
        return sb

    def _pick_chunk_bucket(self, count: int) -> int:
        for b in self.chunk_buckets:
            if count <= b:
                return b
        return self.chunk_buckets[-1]

    def _host_pool(self, req: _TranscribeReq) -> _CachePool:
        """The pool of a host request from its pre-resample length (or the
        pool its prep resolved)."""
        if req.pool_hint is not None:
            return req.pool_hint
        tr = self.transcriber
        est = int(len(req.audio) * 16000 / max(req.sample_rate, 1))
        bucket = tr._pick_bucket(max(1, frame_count(est, tr.mel_cfg)))
        return self._pool_for(bucket, req.max_new_tokens, self._req_suffix_bucket(req))

    def _ring_pool(self, req: _RingTranscribeReq) -> _CachePool:
        cb = self._pick_chunk_bucket(req.chunk_count)
        return self._pool_for(cb * CHUNK_SAMPLES // 160, req.max_new_tokens,
                              self._req_suffix_bucket(req))

    # ---------------- the eager-finals gate ----------------

    def _note_short_queue(self, q_ms: float) -> None:
        """Fold one reaped interim's admission wait into short_queue_ema."""
        self.short_queue_ema = 0.9 * self.short_queue_ema + 0.1 * q_ms

    def eager_ok(self) -> bool:
        """May a session launch an eager (speculative-endpoint) final now?
        Structural: a quarter of the long pool free, no more live streams
        than long slots, no final waiting for a slot, fewer speculative
        slots than half the pool. Measured: interim admissions not queueing
        (short_queue_ema within short_queue_budget_ms), and the bets'
        confirmation EMA at eager_accept_min or above; below it every 8th
        call is let through as a probe, so the EMA stays measured. (The JAX
        package's gate; without it lost bets doubled interim p50 there.)"""
        ok = self._eager_allowed()
        self.stats["eager_granted" if ok else "eager_denied"] += 1
        return ok

    def _eager_allowed(self) -> bool:
        if self.long.free * 4 < len(self.long.slots):
            return False
        if self.N_STREAMS - len(self._free_streams) > len(self.long.slots):
            return False
        if self._ring_backlog:
            return False
        n_spec = sum(1 for s in self.long.slots
                     if s.active and getattr(s.request, "speculative", False))
        if n_spec >= max(1, len(self.long.slots) // 2):
            return False
        if self.short_queue_ema > self.short_queue_budget_ms:
            return False
        self._fold_eager_outcomes()
        if self.eager_accept_ema >= self.eager_accept_min:
            return True
        self._eager_probe += 1
        return self._eager_probe % 8 == 0

    def eager_outcome(self, confirmed: bool) -> None:
        """A session's report of one eager bet: True when its final was
        committed, False when speech resumed or the commit could not use it.
        Folded into eager_accept_ema at most once per eager_window_s."""
        self._eager_pending.append(bool(confirmed))
        self._fold_eager_outcomes()

    def _fold_eager_outcomes(self) -> None:
        now = time.perf_counter()
        if not self._eager_pending or now - self._eager_fold_t < self.eager_window_s:
            return
        mean = sum(self._eager_pending) / len(self._eager_pending)
        self._eager_pending.clear()
        self._eager_fold_t = now
        self.eager_accept_ema = 0.9 * self.eager_accept_ema + 0.1 * mean
        self.stats["eager_accept_ema"] = round(self.eager_accept_ema, 3)

    def confirm_speculative(self, stream_idx: int) -> None:
        """The gate confirmed a stream's speech end: its eager final, in a
        slot, backlogged or still queued, is committed work from now on
        (_pick_k may escalate k for it)."""
        for s in self.long.slots:
            r = s.request
            if (s.active and getattr(r, "speculative", False)
                    and getattr(r, "stream_idx", None) == stream_idx):
                r.speculative = False
        queued = list(getattr(self._ring_requests, "_queue", ()))
        for r in self._ring_backlog + queued:
            if (isinstance(r, _RingTranscribeReq) and r.speculative
                    and r.stream_idx == stream_idx):
                r.speculative = False

    # ---------------- scheduler ----------------

    def _sweep_cancelled(self) -> None:
        """Free slots and drop backlog entries whose caller cancelled (eager
        finals discarded on speech resume, closed clients); a freed slot's
        row simply stops being read (the next prefill into it resets it)."""
        n = 0
        for pool in self.pools:
            for s in pool.slots:
                if s.active and s.request is not None and s.request.future.cancelled():
                    s.active, s.request, s.drafted = False, None, False
                    n += 1
        if n:
            self.stats["cancelled_slots"] = self.stats.get("cancelled_slots", 0) + n
        self._ring_backlog = [r for r in self._ring_backlog if not r.future.done()]
        self._host_backlog = [r for r in self._host_backlog if not r.future.done()]

    @property
    def _n_active(self) -> int:
        return sum(p.n_active for p in self.pools)

    def _run_tick(self, vad_batch, ring_vad_batch) -> None:
        with torch.inference_mode():
            self._tick(vad_batch, ring_vad_batch)

    async def _scheduler(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while self._running:
                # a 3 ms window lets lockstep sessions' gate windows and
                # chunks share one batch and upload
                if not self._vad_requests.empty() or not self._vad_ring_requests.empty():
                    await asyncio.sleep(0.003)
                vad_batch, ring_vad_batch = [], []
                while not self._vad_requests.empty():
                    vad_batch.append(self._vad_requests.get_nowait())
                while not self._vad_ring_requests.empty():
                    ring_vad_batch.append(self._vad_ring_requests.get_nowait())
                while not self._ring_requests.empty():
                    self._ring_backlog.append(self._ring_requests.get_nowait())
                while not self._requests.empty():
                    self._host_backlog.append(self._requests.get_nowait())
                did_work = bool(
                    self._ingest_pending or self._stream_resets or vad_batch or ring_vad_batch
                    or self._ring_backlog or self._host_backlog or self._n_active
                    or self._pending_results
                )
                if did_work:
                    # one executor hop per tick: dispatch every phase, then
                    # resolve the previous tick's copies
                    await loop.run_in_executor(self._executor, self._run_tick, vad_batch,
                                               ring_vad_batch)
                self.stats["ticks"] += 1
                if not did_work:
                    self._wake.clear()
                    try:
                        await asyncio.wait_for(self._wake.wait(), timeout=1.0)
                    except asyncio.TimeoutError:
                        pass
                else:
                    await asyncio.sleep(0)  # let the serving layer ingest
        except asyncio.CancelledError:
            pass
        except Exception as e:
            self._crashed = True
            logger.exception("batcher scheduler crashed")
            self._fail_pending(RuntimeError(f"batcher crashed: {e}"))
        finally:
            self._fail_pending(RuntimeError("batcher stopped"))

    def _fail_pending(self, exc: Exception) -> None:
        """Fail everything the stopped scheduler can no longer serve: parked
        VAD futures, active slots, the backlogs and the intake queues, so
        that no caller is left waiting."""

        def fail(fut: asyncio.Future) -> None:
            if fut is not None and not fut.done():
                def _set(fut=fut):
                    if not fut.done():
                        fut.set_exception(exc)
                try:
                    fut.get_loop().call_soon_threadsafe(_set)
                except RuntimeError:
                    pass  # loop closed; nothing awaits

        pending, self._pending_results = self._pending_results, None
        if pending:
            for chunk in pending["ring_vad_batch"]:
                for r in chunk:
                    fail(r.future)
        for pool in self.pools:
            for s in pool.slots:
                if s.active and s.request is not None:
                    fail(s.request.future)
                s.active, s.request, s.drafted = False, None, False
        backlogs = self._ring_backlog + self._host_backlog
        self._ring_backlog, self._host_backlog = [], []
        for req in backlogs:
            fail(req.future)
        for q in (self._requests, self._vad_requests, self._ring_requests,
                  self._vad_ring_requests):
            while True:
                try:
                    fail(q.get_nowait().future)
                except asyncio.QueueEmpty:
                    break

    def _tick(self, vad_batch: list[_VadReq], ring_vad_batch: list[_VadRingReq]) -> None:
        """One scheduler tick on the device thread, pipelined: dispatch this
        tick's programs (each decode followed by the copy of its status and
        token rows to the host and an event), then resolve the previous
        tick's copies. Finished requests are reaped one tick late; the host
        waits only on work it dispatched a tick earlier."""
        self._sweep_cancelled()
        if self._stream_resets:
            self._reset_streams()
        if self._ingest_pending:
            self._scatter_ingest()
        if vad_batch:
            self._run_vad_batch(vad_batch)
        ring_vad_chunks = _chunked(ring_vad_batch, _VAD_BATCH_BUCKETS[-1])
        ring_vad = [(self._dispatch_vad_ring(c), c) for c in ring_vad_chunks]
        ring_vad = [(p, c) for p, c in ring_vad if p is not None]  # a failed one failed its futures

        # admits; a starved pool with a waiting burst resolves the previous
        # tick first, to free its finished slots
        if self._ring_backlog or self._host_backlog:
            if self._pending_results is not None and self._any_pool_starved():
                self._resolve_pending()
            self._admit_backlogs()
        else:
            self._backlog_has_short = False

        # decode k steps per pool, short first. If every active slot has
        # surely run out its budget, resolve first instead of a wasted step
        if self._pending_results is not None and self._all_surely_done():
            self._resolve_pending()
        parked: list = []
        for pool in self.pools:
            if pool.n_active > 0:
                self._dispatch_decode_pool(pool, parked)

        self._resolve_pending()
        if ring_vad or parked:
            self._pending_results = {"ring_vad": [p for p, _ in ring_vad],
                                     "ring_vad_batch": [c for _, c in ring_vad],
                                     "pools": parked}

    def _all_surely_done(self) -> bool:
        """True if every active slot has been driven past its budget (n
        starts at 1 after prefill), so its done flag is surely set."""
        any_active = False
        for pool in self.pools:
            for s in pool.slots:
                if s.active:
                    any_active = True
                    if s.steps_seen < s.budget - 1:
                        return False
        return any_active

    def _any_pool_starved(self) -> bool:
        """True if a backlogged request routes to a pool with no free slot."""
        return (any(self._ring_pool(r).free == 0 for r in self._ring_backlog)
                or any(self._host_pool(r).free == 0 for r in self._host_backlog))

    def _resolve_pending(self) -> None:
        """Wait for the parked copies of the previous tick (VAD
        probabilities and the short pool first) and resolve them."""
        prev, self._pending_results = self._pending_results, None
        if not prev:
            return
        for (probs, ev), chunk in zip(prev["ring_vad"], prev["ring_vad_batch"]):
            if ev is not None:
                ev.synchronize()
            self.stats["vad_batches"] += 1
            for j, r in enumerate(chunk):
                r.future.get_loop().call_soon_threadsafe(_resolve_quietly, r.future,
                                                         float(probs[j]))
        for pool, status, tokens, ev, reqs in prev["pools"]:
            if ev is not None:
                ev.synchronize()
            self._reap_decode(pool, status.numpy(), tokens.numpy(), reqs)

    def _reset_streams(self) -> None:
        """Fresh VAD state rows for the streams allocated since the last tick."""
        resets, self._stream_resets = self._stream_resets, []
        fresh = self.vad.init_state(1)
        for idx in resets:
            for name, t in self.vad_states.items():
                t[idx : idx + 1].copy_(fresh[name])

    def _scatter_ingest(self) -> None:
        """Every pending chunk of every session in one packed upload and one
        scatter program per bucket of chunks."""
        pending, self._ingest_pending = self._ingest_pending, []
        for group in _chunked(pending, _SCATTER_BUCKETS[-1]):
            M = next(b for b in _SCATTER_BUCKETS if b >= len(group))
            packed = np.zeros((M, CHUNK_SAMPLES), np.int16)
            stream_idx = np.full((M,), self.trash_stream, np.int32)
            chunk_ids = np.zeros((M,), np.int32)
            for j, (s, c, arr) in enumerate(group):
                packed[j], stream_idx[j], chunk_ids[j] = arr, s, c
            key, fn, bufs = self._scatter_entry(M)
            self._put_all(bufs, packed=packed, stream_idx=stream_idx, chunk_ids=chunk_ids)
            self.router.run(key, fn, bufs)
            self.stats["scatter_programs"] = self.stats.get("scatter_programs", 0) + 1

    def _dispatch_vad_ring(self, batch: list[_VadRingReq]):
        """The batched ring-VAD program; -> (probabilities' host copy, its
        event), resolved a tick later; None if it failed (its futures get
        the error)."""
        try:
            B = next(b for b in _VAD_BATCH_BUCKETS if b >= len(batch))
            stream_idx = np.zeros((B,), np.int32)  # padding rows read stream 0
            start, active = np.zeros((B,), np.int32), np.zeros((B,), bool)
            for j, r in enumerate(batch):
                stream_idx[j], start[j], active[j] = r.stream_idx, r.start_chunk, True
            key, fn, bufs = self._vad_ring_entry(B)
            self._put_all(bufs, stream_idx=stream_idx, start_chunk=start, active=active)
            self.router.run(key, fn, bufs)
            return self._to_host(bufs["probs"]), self._event()
        except Exception as e:
            logger.exception("ring vad batch failed")
            for r in batch:
                if not r.future.done():
                    r.future.get_loop().call_soon_threadsafe(r.future.set_exception, e)
            return None

    def _run_vad_batch(self, batch: list[_VadReq]) -> None:
        for chunk in _chunked(batch, _VAD_BATCH_BUCKETS[-1]):
            self._run_vad_batch_one(chunk)

    def _run_vad_batch_one(self, batch: list[_VadReq]) -> None:
        """Host-audio gate windows of several streams in one program,
        resolved inline (the rare path: streams beyond the ring's rows)."""
        try:
            n_sub = max(max(1, len(r.audio) // WINDOW_SAMPLES) for r in batch)
            B = next(b for b in _VAD_BATCH_BUCKETS if b >= len(batch))
            windows = np.zeros((B, n_sub * WINDOW_SAMPLES), np.float32)
            for j, r in enumerate(batch):
                n = min(len(r.audio), n_sub * WINDOW_SAMPLES)
                windows[j, :n] = r.audio[:n]
            fresh = {k: v.cpu().numpy() for k, v in self.vad.init_state(B).items()}
            states = {k: v.copy() for k, v in fresh.items()}
            for j, r in enumerate(batch):
                if r.state is not None:
                    for k in states:
                        states[k][j] = np.asarray(torch.as_tensor(r.state[k]).cpu())[0]
            key, fn, bufs = self._vad_host_entry(B, n_sub)
            self._put_all(bufs, windows=windows.reshape(B, n_sub, WINDOW_SAMPLES))
            self._put_all(bufs["states"], **states)
            self.router.run(key, fn, bufs)
            probs = bufs["probs"].cpu().numpy()  # one wait for the whole batch
            new = {k: v.cpu() for k, v in bufs["states"].items()}
            self.stats["vad_batches"] += 1
            for j, r in enumerate(batch):
                state_j = {k: v[j : j + 1].clone() for k, v in new.items()}
                r.future.get_loop().call_soon_threadsafe(
                    _resolve_quietly, r.future, (float(probs[j]), state_j))
        except Exception as e:
            logger.exception("vad batch failed")
            for r in batch:
                if not r.future.done():
                    r.future.get_loop().call_soon_threadsafe(r.future.set_exception, e)

    # ---------------- admission ----------------

    def _admit_backlogs(self) -> None:
        """Route backlogged requests to their pools, shortest budget first;
        admit what fits each pool's free slots and carry the rest. While the
        short class is busy, long admissions are paced (busy_long_admit_cap
        per tick)."""
        free = {id(p): p.free for p in self.pools}
        if not self._short_quiet():
            free[id(self.long)] = min(free[id(self.long)], self.busy_long_admit_cap)
        self._backlog_has_short = False
        for backlog, route, admit in ((self._ring_backlog, self._ring_pool,
                                       self._admit_ring_grouped),
                                      (self._host_backlog, self._host_pool, self._admit_grouped)):
            if not backlog:
                continue
            keep, take = [], {}
            for req in sorted(backlog, key=lambda r: r.max_new_tokens):
                pool = route(req)
                if free[id(pool)] > 0:
                    free[id(pool)] -= 1
                    take.setdefault(id(pool), []).append(req)
                else:
                    keep.append(req)
                    if pool is self.short:
                        self._backlog_has_short = True
            backlog[:] = keep
            for pool in self.pools:
                if take.get(id(pool)):
                    admit(pool, take[id(pool)])

    def _group_b_cap(self, pool: _CachePool, frame_bucket: int) -> int:
        """Largest prefill group for this (pool, bucket) now: unbounded for
        interims and without streams; else frame-capped, looser while the
        short class is quiet."""
        if pool is self.short or len(self._free_streams) >= self.N_STREAMS:
            return 10**9
        cap = self.quiet_prefill_frame_cap if self._short_quiet() \
            else self.live_busy_prefill_frame_cap
        return max(1, cap // max(frame_bucket, 1))

    def _group_sizes(self, pool: _CachePool, compiled: set, bucket: int, sb: int,
                     frame_bucket: int, n: int) -> list[int]:
        """n requests of one (bucket, suffix bucket) as groups of the largest
        registered batch size that fits (B = 1 always)."""
        b_cap, out = self._group_b_cap(pool, frame_bucket), []
        while n > 0:
            B = max((b for b in self.prefill_batch_choices
                     if b <= n and b <= b_cap and (bucket, sb, b) in compiled), default=1)
            out.append(B)
            n -= B
        return out

    def _claim_slots(self, pool: _CachePool, n: int) -> list[int]:
        free = [i for i, s in enumerate(pool.slots) if not s.active]
        assert len(free) >= n, "scheduler overfilled slots"
        return free[:n]

    def _activate(self, pool: _CachePool, items: list, slot_list: list[int]) -> None:
        t_admit = time.perf_counter()
        if pool is self.short:
            self._last_short_admit = t_admit
        for req, slot_idx in zip(items, slot_list):
            req.t_admit = t_admit
            st = pool.slots[slot_idx]
            st.request, st.budget, st.active, st.steps_seen = req, req.max_new_tokens, True, 0
        self.stats["prefills"] += len(items)
        self.stats["prefill_programs"] += 1

    def _fail_group(self, items: list, e: Exception) -> None:
        logger.exception("prefill group failed")
        for req in items:
            if not req.future.done():
                req.future.get_loop().call_soon_threadsafe(req.future.set_exception, e)

    def _admit_ring_grouped(self, pool: _CachePool, reqs: list[_RingTranscribeReq]) -> None:
        by_key: dict = {}
        for req in reqs:
            by_key.setdefault((self._pick_chunk_bucket(req.chunk_count),
                               self._req_suffix_bucket(req)), []).append(req)
        for (bucket, sb), items in by_key.items():
            idx = 0
            for B in self._group_sizes(pool, pool.compiled_ring_prefill, bucket, sb,
                                       bucket * CHUNK_SAMPLES // 160, len(items)):
                self._admit_ring_group(pool, bucket, sb, items[idx : idx + B], B)
                idx += B

    def _admit_ring_group(self, pool: _CachePool, bucket: int, sb: int,
                          items: list[_RingTranscribeReq], B: int) -> None:
        tr = self.transcriber
        slot_list = self._claim_slots(pool, len(items))
        stream_idx = np.full((B,), self.trash_stream, np.int32)
        start, count = np.zeros((B,), np.int32), np.ones((B,), np.int32)
        suffixes = np.full((B, sb), self.cfg.pad_id, np.int32)
        suffix_lens, budgets = np.zeros((B,), np.int32), np.zeros((B,), np.int32)
        prefix = None
        for j, req in enumerate(items):
            prompt = build_prompt(tr.tokenizer, self.cfg, hotwords=req.hotwords)
            prefix = prompt.prefix_ids
            s_ids = prompt.suffix_ids[:sb]
            suffixes[j, : len(s_ids)], suffix_lens[j] = s_ids, len(s_ids)
            # over-long windows keep the host path's tail truncation
            stream_idx[j], start[j] = req.stream_idx, req.start_chunk
            count[j] = max(1, min(req.chunk_count, bucket))
            budgets[j] = req.max_new_tokens
        try:
            self._set_slot_bias(pool, [(s, self._hotword_ids(r.hotwords))
                                       for s, r in zip(slot_list, items)])
            draft_rows, draft_lens = self._prep_draft_rows(
                pool, [(s, r.draft_tokens) for s, r in zip(slot_list, items)], B)
            key, fn, bufs = self._prefill_entry(pool, True, bucket, sb, B, len(prefix))
            self._put_all(bufs, prefix_ids=prefix, stream_idx=stream_idx, start_chunk=start,
                          chunk_count=count, suffix_ids=suffixes, suffix_lens=suffix_lens,
                          slots=slot_list + [pool.trash_slot] * (B - len(items)),
                          budget_vals=budgets, draft_rows=draft_rows, draft_lens=draft_lens)
            self.router.run(key, fn, bufs)
        except Exception as e:
            self._fail_group(items, e)
            return
        self._activate(pool, items, slot_list)
        self.stats["ring_prefill_programs"] += 1

    def _prep_draft_rows(self, pool: _CachePool, slot_drafts: list, B: int):
        """The admit group's draft rows [B, W] and lengths [B] (padding rows
        empty), and each slot's drafted / spec_rounds. A draft is used when
        speculative finals are on, it has more than one token and the
        acceptance EMA is at spec_accept_min or above; its token 0 is
        dropped (it predicts the prefill's own first token)."""
        W = pool.state["draft"].shape[1]
        rows = np.full((B, W), self.cfg.pad_id, np.int32)
        lens = np.zeros((B,), np.int32)
        for j, (slot, d) in enumerate(slot_drafts):
            use = (self.speculative and d is not None and len(d) > 1
                   and self.spec_accept_ema >= self.spec_accept_min)
            if use:
                dd = np.asarray(d, np.int32)[1 : W + 1]
                rows[j, : len(dd)], lens[j] = dd, len(dd)
            pool.slots[slot].drafted = bool(use)
            pool.slots[slot].spec_rounds = -(-int(lens[j]) // self.spec_w) if use else 0
        return rows, lens

    def _hotword_ids(self, hotwords) -> Optional[list[int]]:
        """Token ids to boost (deduped, sorted), None without hotwords."""
        tr = self.transcriber
        if not hotwords or tr.hotword_bias_strength == 0.0:
            return None
        ids: set[int] = set()
        for w in hotwords[:10]:
            ids.update(tr.tokenizer.encode(str(w).strip().lower()))
        return sorted(ids)

    def _set_slot_bias(self, pool: _CachePool, slot_bias: list) -> None:
        """Hotword bias rows of an admit group: the base bias plus the
        hotword strength at the boosted ids; a row left dirty by an earlier
        hotword request goes back to the base."""
        bias = pool.state["bias"]
        for slot, ids in slot_bias:
            if ids:
                row = self._base_bias.clone()
                idx = torch.from_numpy(np.asarray(ids, np.int64))
                if self.device.type == "cuda":
                    idx = idx.pin_memory().to(self.device, non_blocking=True)
                row[idx] += self.transcriber.hotword_bias_strength
                bias[slot].copy_(row)
                pool.bias_dirty[slot] = True
            elif pool.bias_dirty[slot]:
                bias[slot].copy_(self._base_bias)
                pool.bias_dirty[slot] = False

    def _prepare_request(self, req: _TranscribeReq):
        """Host request -> (bucket, mel [bucket, n_mels] on the device,
        frames, prefix, suffix [sb], suffix_len, sb), or None if it failed
        (its future gets the error). The mel is the log-mel kernel's."""
        tr = self.transcriber
        try:
            x = tr.prepare_audio(req.audio, req.sample_rate)
            frames = max(1, frame_count(int(x.shape[0]), tr.mel_cfg))
            bucket = tr._pick_bucket(frames)
            if frames > bucket:
                frames = bucket
                x = x[: bucket * tr.mel_cfg.hop_length]
            mel = log_mel_spectrogram(x, tr.mel_cfg, pad_to_frames=bucket).to(tr.dtype)
            self.stats["mel_preps"] += 1
            prompt = build_prompt(tr.tokenizer, self.cfg, hotwords=req.hotwords)
            s_ids = prompt.suffix_ids[:MAX_SUFFIX_TOKENS]
            sb = self._suffix_bucket(len(s_ids))
            suffix = np.full((sb,), self.cfg.pad_id, np.int32)
            suffix[: len(s_ids)] = s_ids
            return bucket, mel, frames, prompt.prefix_ids, suffix, len(s_ids), sb
        except Exception as e:
            logger.exception("request prep failed")
            if not req.future.done():
                req.future.get_loop().call_soon_threadsafe(req.future.set_exception, e)
            return None

    def _admit_grouped(self, pool: _CachePool, reqs: list[_TranscribeReq]) -> None:
        """Prepare each request, group by (mel bucket, suffix bucket), one
        prefill program per group of a registered size."""
        by_key: dict = {}
        for req in reqs:
            prep = self._prepare_request(req)
            if prep is None:
                continue
            # the routing estimate used the pre-resample length; if the true
            # bucket routes elsewhere, requeue with the resolved pool
            real_pool = self._pool_for(prep[0], req.max_new_tokens, prep[6])
            if real_pool is not pool:
                req.pool_hint = real_pool
                self._host_backlog.append(req)
                continue
            by_key.setdefault((prep[0], prep[6]), []).append((req, prep))
        for (bucket, sb), items in by_key.items():
            idx = 0
            for B in self._group_sizes(pool, pool.compiled_prefill, bucket, sb, bucket,
                                       len(items)):
                self._admit_group(pool, bucket, sb, items[idx : idx + B], B)
                idx += B

    def _admit_group(self, pool: _CachePool, bucket: int, sb: int, items: list, B: int) -> None:
        slot_list = self._claim_slots(pool, len(items))
        pad = B - len(items)
        preps = [p for _, p in items] + [items[0][1]] * pad  # padding repeats the first row
        try:
            self._set_slot_bias(pool, [(s, self._hotword_ids(r.hotwords))
                                       for s, (r, _) in zip(slot_list, items)])
            draft_rows, draft_lens = self._prep_draft_rows(
                pool, [(s, r.draft_tokens) for s, (r, _) in zip(slot_list, items)], B)
            key, fn, bufs = self._prefill_entry(pool, False, bucket, sb, B, len(preps[0][3]))
            bufs["mels"].copy_(torch.stack([p[1] for p in preps]))
            self._put_all(
                bufs, prefix_ids=preps[0][3],
                n_frames=[p[2] for _, p in items] + [bucket] * pad,
                suffix_ids=np.stack([p[4] for p in preps]),
                suffix_lens=[p[5] for p in preps],
                slots=slot_list + [pool.trash_slot] * pad,
                budget_vals=[r.max_new_tokens for r, _ in items] + [0] * pad,
                draft_rows=draft_rows, draft_lens=draft_lens)
            self.router.run(key, fn, bufs)
        except Exception as e:
            self._fail_group([r for r, _ in items], e)
            return
        self._activate(pool, [r for r, _ in items], slot_list)

    # ---------------- decode ----------------

    def _short_quiet(self) -> bool:
        """The short (interim) class is quiet: nothing in flight, nothing
        short backlogged, no admission for short_quiet_s."""
        return (self.short.n_active == 0 and not self._backlog_has_short
                and time.perf_counter() - self._last_short_admit > self.short_quiet_s)

    def _pick_k(self, pool: _CachePool) -> int:
        """The device enforces exact budget and EOS stops; k only shapes
        latency: the smallest choice >= the least remaining steps finishes
        the most urgent slot in one tick, capped while requests wait or
        realtime streams are live."""
        remaining = [max(1, s.budget - 1 - s.steps_seen) for s in pool.slots if s.active]
        min_rem = max(1, min(remaining)) if remaining else 1
        choices = self.dual_k_choices if pool is self.short else _DECODE_K_CHOICES
        k = next((c for c in choices if c >= min_rem), choices[-1])
        # an unconfirmed eager final escalates in a quiet window only while
        # the bets' confirmation EMA is healthy: a lost bet's long program
        # would hold back the resumed speech's interims
        spec_escalate = self.eager_accept_ema >= self.eager_accept_min
        long_quiet = (pool is self.long and self._short_quiet()
                      and any(s.active and (spec_escalate
                                            or not getattr(s.request, "speculative", False))
                              for s in pool.slots))
        waiting = (self._ring_backlog or self._host_backlog or not self._requests.empty()
                   or not self._ring_requests.empty() or not self._vad_ring_requests.empty()
                   or not self._vad_requests.empty())
        if waiting and not long_quiet:
            k = min(k, self.pending_k_cap)
        live = self.N_STREAMS - len(self._free_streams)
        if live > 0:
            if pool is self.short:
                cap = self.live_k_cap
            elif long_quiet:
                cap = self.long_idle_k_cap
            elif live > len(self.long.slots) and self.short_queue_ema <= self.short_queue_budget_ms:
                cap = self.long_oversub_k_cap
            else:
                cap = self.long_live_k_cap
            k = min(k, cap)
        return k

    def _pick_rows(self, pool: _CachePool, k: int) -> Optional[int]:
        """The smallest registered rows rung covering every active slot; None
        = the full pool."""
        high = max((i + 1 for i, s in enumerate(pool.slots) if s.active), default=0)
        return next((r for r in pool.rows_ladder
                     if r >= high and (k, r) in pool.compiled_decode), None)

    def _dispatch_decode_pool(self, pool: _CachePool, parked: list) -> None:
        """Pick k and rows, replay the pool's decode program (or, with a
        drafted slot live, its verify program for some rounds) and park its
        status and token rows."""
        k = self._pick_k(pool)
        rounds = self._pick_verify_rounds(pool, k)
        if rounds is not None:
            rows = self._pick_verify_rows(pool, rounds)
            self.router.run(self._verify_key(pool, rounds, rows), self._verify_fn(rounds, rows),
                            pool.state)
            pool.compiled_verify.add((rounds, rows))
            self.stats["verify_rounds"] += rounds
            for s in pool.slots:
                if s.active and s.drafted:
                    s.spec_rounds -= rounds
                    # past the rounds a draft can cover: back to the plain
                    # ladder without waiting for the (one tick late) flag
                    if s.spec_rounds <= 0:
                        s.drafted = False
            self._park(pool, rounds, parked)
            return
        rows = self._pick_rows(pool, k)
        self.router.run(("decode", pool.name, k, rows), self._decode_fn(k, rows), pool.state)
        pool.compiled_decode.add((k, rows))
        self._park(pool, k, parked)

    def _park(self, pool: _CachePool, steps: int, parked: list) -> None:
        """Count a dispatched program's steps and park its status and token
        rows (host copies after it on the stream, and an event) with the
        slots' request identities."""
        self.stats["decode_steps"] += steps
        for s in pool.slots:
            if s.active:
                s.steps_seen += steps
        status, tokens = self._to_host(pool.state["status"]), self._to_host(pool.state["out"])
        parked.append((pool, status, tokens, self._event(), [s.request for s in pool.slots]))

    def _pick_verify_rounds(self, pool: _CachePool, k: int) -> Optional[int]:
        """Rounds of the verify program while a drafted slot is live in the
        long pool, else None (the plain k-step program): the smallest
        registered choice covering the deepest live draft (any of
        verify_rounds_choices before one is registered), capped at k (a
        round costs about a decode step). The short pool never verifies:
        warmup registers no verify program there, so a drafted short
        request takes the plain ladder, as on a warmed JAX engine (an
        unwarmed one would build a short-pool verify program on demand)."""
        if (not self.speculative or pool is not self.long
                or not any(s.active and s.drafted for s in pool.slots)):
            return None
        choices = (sorted({r for r, rows in pool.compiled_verify if rows is None})
                   or sorted(self.verify_rounds_choices))
        needed = max((s.spec_rounds for s in pool.slots if s.active and s.drafted), default=1)
        cap = max((r for r in choices if r <= k), default=choices[0])
        return min(next((r for r in choices if r >= min(needed, cap)), cap), cap)

    def _pick_verify_rows(self, pool: _CachePool, rounds: int) -> Optional[int]:
        """The smallest registered rows rung of the verify program covering
        every active slot; None = the full pool."""
        high = max((i + 1 for i, s in enumerate(pool.slots) if s.active), default=0)
        return next((r for r in pool.rows_ladder
                     if r >= high and (rounds, r) in pool.compiled_verify), None)

    def _reap_decode(self, pool: _CachePool, status: np.ndarray, rows: np.ndarray,
                     reqs: list) -> None:
        """status and rows come from the same program: a slot done there
        stays frozen, so its row is final. Only a slot still holding the
        request it held at dispatch may be finished. A drafted slot whose
        status lacks _SPEC_LIVE_FLAG (its draft spent, or a plain program
        ran) goes back to the plain ladder."""
        for i, s in enumerate(pool.slots):
            if not (s.active and s.request is not None and s.request is reqs[i]):
                continue
            if status[i] < 0:
                self._finish(pool, i, rows[i], int(-status[i] - 1))
            elif s.drafted and status[i] < _SPEC_LIVE_FLAG:
                s.drafted = False

    def _finish(self, pool: _CachePool, slot_idx: int, row: np.ndarray, n_tokens: int) -> None:
        st = pool.slots[slot_idx]
        req = st.request
        out = []
        for t in row[:n_tokens]:
            if int(t) in (self.cfg.eos_id, self.cfg.pad_id):
                break
            out.append(int(t))
        if isinstance(req, _RingTranscribeReq):
            duration = req.duration_s
        else:
            duration = len(req.audio) / req.sample_rate
        dt = time.perf_counter() - req.t_enqueue
        # queue = enqueue -> prefill dispatch, run = dispatch -> reap
        queue_s = max(0.0, req.t_admit - req.t_enqueue) if req.t_admit else 0.0
        result = TranscribeResult(
            text=self.transcriber.tokenizer.decode(out),
            tokens=np.asarray(out, np.int32),
            audio_duration_s=duration,
            timings={"total_s": dt, "rtf": dt / max(duration, 1e-6), "queue_s": queue_s,
                     "run_s": dt - queue_s},
        )
        lat = self.stats.setdefault(pool.name + "_lat_ms", {"queue": [], "run": [], "tokens": []})
        if len(lat["queue"]) < 4000:
            lat["queue"].append(round(queue_s * 1e3, 1))
            lat["run"].append(round((dt - queue_s) * 1e3, 1))
            lat["tokens"].append(n_tokens)
        if pool is self.short:
            self._note_short_queue(queue_s * 1e3)
        draft = req.draft_tokens
        if self.speculative and draft is not None and len(draft) > 1:
            # acceptance: the draft's matching prefix against the output,
            # which is the greedy one whether or not the draft was spent
            match = 0
            for a, b in zip(np.asarray(draft), out):
                if int(a) != int(b):
                    break
                match += 1
            self.spec_accept_ema = 0.8 * self.spec_accept_ema + 0.2 * match / len(draft)
            self.stats["spec_accept_ema"] = round(self.spec_accept_ema, 3)
        self.stats["requests"] += 1
        self.stats["tokens"] += n_tokens
        st.active, st.request, st.drafted = False, None, False
        if not req.future.done():
            req.future.get_loop().call_soon_threadsafe(_resolve_quietly, req.future, result)
