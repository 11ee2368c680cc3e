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
- FUSED DUAL DECODE (``fuse_dual_decode``, off by default as in JAX): while
  both pools are active, one program per k decodes both, the layer weights
  read once a step (models/glm_asr.py:decode_step_dual); its k is the short
  pool's pick, and the long pool's drafted slots take plain steps in it.
- SELF-HEAL: a tick stuck past ``tick_stall_dump_s`` dumps every thread's
  stack; past ``tick_stall_abort_s`` the scheduler crashes, fails every
  caller and reports ``alive`` False (/health "degraded"). The stuck tick
  cannot be cancelled (a wedged graph replay or event synchronize holds its
  thread); ``start()`` refuses to spawn a scheduler while it is still
  running, and the next request after it drains restarts one in-process.
- WARMUP: ``warmup()`` captures the default grid before serving;
  ``warmup(full=True)`` every batch size of each pool; ``warmup(fast=True)``
  leaves what serving can start without (the JAX package's deferred set) to
  the scheduler's idle ticks, one capture each, in JAX's priority order.

Programs are functions of one dict of static buffers, written in place:
each pool's state is the graphs' static memory, and admission copies a
request's inputs into static input buffers (never rebinding them). On the
card ``engine/exec_store.py``'s GraphRouter captures each program key as a
CUDA graph on first use (or in ``warmup``) and replays it; on the CPU
(``device="cpu"``, as the tests ask) the same programs run eagerly. All
device work runs on one executor thread, which makes the engine's card
current; the event loop never touches the device. Data parallelism is a
batcher per card behind ``engine/replicas.py``'s router (JAX's is this
engine over a mesh).

TENSOR PARALLELISM (``tp_group``): the engine is rank 0 of a group
(parallel/tp.py) and mirrors itself on the other ranks. Each rank has an
engine of its own (``_ranks``: its Transcriber over its shard tree, its
pools with its share of the KV heads, its ring, buffers and router, on its
card), which never schedules. Every program that touches the model or a
pool, and every host-to-device write such a program reads (the prefill
groups' inputs and bias rows, the packed ring scatter, the warmup's
exercise), runs on every rank, in the same order, on the same host inputs,
through ``_ranks_do``: the group runs it on all ranks at once, so the
all-reduces inside the programs meet. Each rank picks its own greedy
tokens from the same reduced bits, so its slots stay equal to rank 0's.
The scheduler, admission, the eager gate, the drafts, the host copies of
the results and the VAD (whose programs hold no collective and feed only
the scheduler) are rank 0's alone.
"""

from __future__ import annotations

import asyncio
import contextlib
import faulthandler
import functools
import logging
import os
import threading
import time
from collections import deque
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
    decode_step_dual,
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
# buffers a capture's eager warm run reads and writes in place instead of on
# copies: the pools' K/V and the audio ring. Its writes land where no live
# slot reads before its next step writes them again (a slot's K/V at or past
# its length, the trash slot's rows, the trash stream's ring rows), so the
# warm run needs no copy of the caches, which were most of the capture peak
_WARM_IN_PLACE = ("k", "v", "ring")


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


def _decode_k_dual_program(params, cfg: GlmAsrConfig, bufs: dict, k: int) -> dict:
    """k greedy steps for BOTH pools in one program (the JAX package's
    _decode_k_dual_program): decode_step_dual reads the layer weights once
    a step for the short pool's rows and the long pool's, each pool's
    bookkeeping is _decode_k_program's on all of its rows, then each pool's
    status row (no draft flag: drafted slots take plain steps here). bufs:
    {"short": the short pool's state, "long": the long pool's}."""
    a, b = bufs["short"], bufs["long"]
    ca = {"k": a["k"], "v": a["v"], "len": a["len"]}
    cb = {"k": b["k"], "v": b["v"], "len": b["len"]}
    for _ in range(k):
        _, la, _, lb = decode_step_dual(params, cfg, ca, a["tok"], cb, b["tok"],
                                        active_a=~a["done"], active_b=~b["done"])
        for st, logits in ((a, la), (b, lb)):
            nxt, n_new, dn_new = _book_step(cfg, logits, st["bias"], st["done"], st["tok"],
                                            st["out"], st["n"], st["budget"], st["out"].shape[1])
            st["tok"].copy_(nxt)
            st["n"].copy_(n_new)
            st["done"].copy_(dn_new)
    for st in (a, b):
        st["status"].copy_(torch.where(st["done"], -(st["n"] + 1), st["n"] + 1))
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


def _make_vad_batch_program(vad):
    """Host-audio gate windows: bufs windows [B, n_sub, 512] and states
    {field: [B, ...]} -> max probability over the sub-windows per row into
    probs, the states after them in place."""

    def program(bufs: dict) -> dict:
        probs, states = vad.forward_windows(vad.params, bufs["windows"], dict(bufs["states"]))
        for name, t in bufs["states"].items():
            t.copy_(states[name])
        bufs["probs"].copy_(probs.amax(dim=1))
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
class _GridKey:
    """One program of the warmup grid: its key, how to make its (key,
    program, buffers) and how to register it for dispatch once captured;
    `deferred` (fast warmup leaves it to idle ticks) and `prio` (their
    order, 0 first) as the JAX package's warmup marks it."""

    key: tuple
    entry: Any  # (engine) -> (key, program, buffers): a rank's own
    register: Any  # () -> None
    deferred: bool = False
    prio: int = 3


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
        fuse_dual_decode: bool = False,
        tp_group=None,
        tp_followers=(),
    ):
        """fuse_dual_decode: decode both pools in one program while both
        are active (see _decode_k_dual_program); off by default, as in the
        JAX package, where the v5e measured no win (``fuse_dual``, which a
        caller may flip between runs).

        tp_group: a parallel/tp.py group whose rank 0 `transcriber` is;
        tp_followers: the Transcribers of ranks 1.. (each over its shard
        tree, on its card), whose engines this one drives. `vad` None: no
        VAD (a follower's engine)."""
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
        self.router = GraphRouter(self.device, warm_in_place=_WARM_IN_PLACE)
        self.fuse_dual = bool(fuse_dual_decode)

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
        # the dual program's static buffers: both pools' state
        self._dual_bufs = {"short": self.short.state, "long": self.long.state}
        self._compiled_dual: set = set()  # the dual programs' k warmup registered
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
        self.vad_states = vad.init_state(n_streams + 1) if vad is not None else None
        self._stream_resets: list[int] = []
        if vad is not None:
            self._vad_ring_program = make_vad_ring_program(vad, _GATE_WINDOW_CHUNKS)
            self._vad_host_program = _make_vad_batch_program(vad)
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
        # watchdog: a tick blocked this long dumps every thread's stack (the
        # tick keeps running); this long, the scheduler crashes and fails
        # every caller instead of hanging them (the JAX package's values)
        self.tick_stall_dump_s = 60.0
        self.tick_stall_abort_s = 600.0
        # ticks running on the executor thread, counted by that thread
        # (_run_tick_guarded), so that the count holds even when the loop
        # that dispatched a wedged tick is gone; start() refuses to spawn a
        # scheduler while it is non-zero, under the lock the tick holds
        # while it finishes
        self._tick_lock = threading.Lock()
        self._tick_busy = 0
        # fast warmup's deferred grid keys (_GridKey), captured one per idle
        # tick (or by warmup_join / drain_replays); `_deferred_inflight`:
        # popped and not yet registered
        self._replay_queue: deque = deque()
        self._deferred_inflight = 0
        self._warmed = False  # set by warmup(): dispatch only registered programs
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
                      "eager_denied": 0, "dual_decodes": 0, "warmup_capture_failures": 0}
        # per-tick phase times (SONIC_TICK_TRACE set): host times of
        # dispatch, as in the JAX package; no device sync is added
        self.tick_trace: Optional[deque] = (
            deque(maxlen=4096) if os.environ.get("SONIC_TICK_TRACE") else None)
        # the admit phase's split while tracing: host prep, input writes,
        # program dispatch, and groups per pool
        self._trace_admit: Optional[dict] = None
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
        # rationing: admit the short class, dispatch the short decode, then
        # admit the long class (off by default: the JAX package measured
        # it a net loss); the dual decode always admits both first
        self.ration_long_admits = False
        # spread lockstep interim cohorts over eight phases (interim_stagger)
        self.stagger_interims = True
        # the file pipeline may run this many segment decodes at once
        self.concurrency_hint = slots
        # total mel frames of a long-pool prefill group while the short class
        # is active, and while it is quiet
        self.live_busy_prefill_frame_cap = 512
        self.quiet_prefill_frame_cap = 2048

        # tensor parallelism: every rank's engine, this one first
        self.tp = tp_group
        self.tp_degree = tp_group.size if tp_group is not None else 1
        if len(tp_followers) != self.tp_degree - 1:
            raise ValueError(f"{len(tp_followers)} follower transcribers for a group of "
                             f"{self.tp_degree}")
        self._ranks = [self] + [
            BatchedEngine(tr, None, slots=slots, max_decode_tokens=max_decode_tokens,
                          n_streams=n_streams, base_logit_bias=base_logit_bias)
            for tr in tp_followers]

    @property
    def alive(self) -> bool:
        """False once the scheduler has crashed; True before the first start
        and after a graceful shutdown."""
        return not self._crashed

    # ---------------- public async interface ----------------

    async def start(self) -> None:
        """Spawn the scheduler on this loop unless one runs here: also after
        a crash (the next request restarts the engine in-process) and on a
        new loop. Raises RuntimeError while a crashed scheduler's wedged
        tick still runs on the executor thread: a new scheduler would race
        it on pool state, and only a process restart ends a lasting wedge."""
        loop = asyncio.get_running_loop()
        if self._task is not None and (self._task.done() or self._loop is not loop):
            if not self._task.done():
                try:
                    self._task.cancel()
                except RuntimeError:
                    pass  # the old loop is closed
            self._task = None
        if self._task is None:
            # a scheduler stopped without a crash (its loop closed) may leave
            # its last tick finishing on the executor: wait that out
            t0 = time.perf_counter()
            while (self._tick_busy and not self._crashed
                   and time.perf_counter() - t0 < self.tick_stall_abort_s):
                await asyncio.sleep(0.002)
            with self._tick_lock:
                if self._tick_busy:
                    raise RuntimeError("batcher crashed and the wedged device tick is still "
                                       "stuck; restart the process")
                # a restart clears the crash: /health reports this scheduler
                self._crashed = False
            self._loop = loop
            self._device_thread()
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
        spread over eight phases; 0 with stagger_interims off."""
        if not self.stagger_interims:
            return 0.0
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

    def _grid(self, full: bool = False) -> dict:
        """The program grid, as the JAX package's warmup picks it:
        {"host" | "ring": [(pool, bucket, sb, B)], "decode" | "verify":
        [(pool, k or rounds, rows)]}. Short pool: every batch size for the
        interim ring path at the smallest chunk bucket, (1, 4) host and 1
        elsewhere; long pool: a group ladder (1, 2, 4, 8 as the live frame
        cap allows, and 4 and 8) for the default suffix bucket, 1 for
        hotword prompts; `full`: every batch size of the pool everywhere.
        Decode every k of the pool's ladder, rows variants for k >= 8; with
        speculative finals, verify every rounds choice on the full pool and
        rows 1 and 4 (long pool only: finals are what carry drafts, and a
        drafted short request takes the plain ladder)."""
        tr = self.transcriber
        smallest, smallest_cb = min(tr.buckets), min(self.chunk_buckets)
        grid = {"host": [], "ring": [], "decode": [], "verify": []}

        def choices(pool, ring: bool, is_smallest: bool, sb: int, frame_bucket: int, pc):
            if full:
                return pc
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

    def _grid_keys(self, grid: dict, P: int) -> list[_GridKey]:
        """The grid's programs in the JAX package's warmup order (per pool:
        host prefills, decode, verify, ring prefills; then the dual
        programs), each marked as JAX's fast warmup marks it
        (batcher.py:1620-1745). Deferred: host prefills at B > 1, ring
        prefills at long B > 1 and short B > 8, decode rows variants, long
        decode at k > long_live_k_cap, the whole verify grid. Priority (0
        first): short ring prefills at the smallest chunk bucket 0, other
        short ring prefills and the short decode ladder 1, short host
        prefills, long B = 1 default-suffix prefills, long ring prefills at
        B = 1 and long full-rows decode up to long_oversub_k_cap 2, the
        rest 3."""
        sb0, smallest_cb = self.suffix_buckets[0], min(self.chunk_buckets)
        items: list[_GridKey] = []

        def prefill(pool, ring, bucket, sb, B, deferred, prio):
            compiled = pool.compiled_ring_prefill if ring else pool.compiled_prefill
            items.append(_GridKey(
                key=self._prefill_key(pool, ring, bucket, sb, B, P),
                entry=lambda eng, name=pool.name, a=(ring, bucket, sb, B, P):
                    eng._prefill_entry(eng._pool(name), *a),
                register=functools.partial(compiled.add, (bucket, sb, B)),
                deferred=deferred, prio=prio))

        def program(key, make, register, deferred, prio):
            """make(engine) -> (program, buffers) of that rank's engine."""
            items.append(_GridKey(key=key, entry=lambda eng: (key, *make(eng)),
                                  register=register, deferred=deferred, prio=prio))

        for pool in self.pools:
            short = pool is self.short
            for p, bucket, sb, B in grid["host"]:
                if p is pool:
                    prefill(pool, False, bucket, sb, B, B > 1,
                            2 if short or (B == 1 and sb == sb0) else 3)
            for p, k, rows in grid["decode"]:
                if p is pool:
                    program(("decode", pool.name, k, rows),
                            lambda eng, n=pool.name, k=k, rows=rows: (eng._decode_fn(k, rows),
                                                                      eng._pool(n).state),
                            functools.partial(pool.compiled_decode.add, (k, rows)),
                            rows is not None or (not short and k > self.long_live_k_cap),
                            1 if short else 2 if rows is None and k <= self.long_oversub_k_cap
                            else 3)
            for p, r, rows in grid["verify"]:
                if p is pool:
                    program(self._verify_key(pool, r, rows),
                            lambda eng, n=pool.name, r=r, rows=rows: (eng._verify_fn(r, rows),
                                                                      eng._pool(n).state),
                            functools.partial(pool.compiled_verify.add, (r, rows)), True, 3)
            for p, cb, sb, B in grid["ring"]:
                if p is pool:
                    prefill(pool, True, cb, sb, B, B > 8 if short else B > 1,
                            (0 if cb == smallest_cb else 1) if short else 2 if B == 1 else 3)
        if self.fuse_dual:
            for k in self.dual_k_choices:
                program(("decode_dual", k), lambda eng, k=k: (eng._dual_fn(k), eng._dual_bufs),
                        functools.partial(self._compiled_dual.add, k), False, 1)
        return items

    def warmup(self, budgets=(15, 200, 256), full: bool = False, fast: bool = False) -> dict:
        """Register the program grid (`_grid`; every batch size with
        `full`) for both pools and, on the card, capture each of its CUDA
        graphs synchronously, with the dual programs (fusion on), the VAD
        and scatter programs; then one admit -> decode -> reap per pool.
        Dispatch is gated to registered programs from then on. Without it
        (--no-warmup) prefill groups admit at B = 1 and each key is
        captured by its first use.

        `fast`: two-phase boot. The keys serving can start without (the
        JAX package's deferred set, `_grid_keys`) are neither captured nor
        registered here: the scheduler's idle ticks capture them one at a
        time in priority order and register each once captured, and until
        then finals admit in B = 1 groups, decode runs on full rows, long
        k is clamped to registered rungs and drafted finals take plain
        steps. ``warmup_join`` / ``drain_replays`` capture what is left.

        On the CPU nothing is captured: the grid is only registered (fast:
        the deferred keys queued the same way). -> {"graphs", "seconds",
        "deferred"}."""
        del budgets  # a decode program serves every budget
        t0 = time.perf_counter()
        prompt, n_suffix = self._prompt_defaults()
        items = self._grid_keys(self._grid(full=full), len(prompt.prefix_ids))
        deferred = [item for item in items if fast and item.deferred]
        cuda = self.device.type == "cuda"
        with torch.inference_mode(), self._on_device():
            for item in items:
                if fast and item.deferred:
                    continue
                if cuda:
                    self._ranks_do(lambda eng: eng.router.prepare(*item.entry(eng)))
                item.register()
            t1 = time.perf_counter()
            if cuda:
                for B in _VAD_BATCH_BUCKETS:
                    self.router.prepare(*self._vad_host_entry(B, _GATE_SUB_WINDOWS))
                    self.router.prepare(*self._vad_ring_entry(B))
                for M in _SCATTER_BUCKETS:
                    self._ranks_do(lambda eng: eng.router.prepare(*eng._scatter_entry(M)))
                for pool in self.pools:
                    self._ranks_do(lambda eng: eng._exercise(eng._pool(pool.name), prompt,
                                                             n_suffix))
                for eng in self._ranks:
                    torch.cuda.synchronize(eng.device)
        deferred.sort(key=lambda item: item.prio)  # stable: grid order within a priority
        self._replay_queue.extend(deferred)
        self._warmed = True
        t2 = time.perf_counter()
        out = {"graphs": self.router.stats["graphs"], "seconds": t2 - t0,
               "deferred": len(deferred)}
        self.stats["warmup_graphs"] = out["graphs"]
        self.stats["warmup_s"] = round(out["seconds"], 1)
        self.stats["warmup_phase_s"] = {"grid": round(t1 - t0, 3),
                                        "vad_scatter_exercise": round(t2 - t1, 3)}
        self._note_deferred()
        return out

    def _device_thread(self) -> ThreadPoolExecutor:
        """The executor whose one thread runs the ticks and the deferred
        captures (made on first use). Its thread makes the engine's card
        current once, at its start: every tick, capture, replay and host
        copy on it lands there, whichever card the caller's thread has."""
        if self._executor is None:
            self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="batcher",
                                                initializer=self._pin_device)
        return self._executor

    def _pin_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _ranks_do(self, fn):
        """fn(engine) on every rank's engine (``_ranks``) at once, through
        the tensor-parallel group; -> this engine's result. Without a group
        fn(self)."""
        if self.tp is None:
            return fn(self)
        return self.tp.run(lambda r: fn(self._ranks[r]))

    def _pool(self, name: str) -> _CachePool:
        return self.short if name == "short" else self.long

    def _on_device(self):
        """The engine's card current for the calling thread's block (the
        caller's own thread: warmup)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _note_deferred(self) -> None:
        """stats: deferred keys not yet registered (queued or being
        captured) and those still queued."""
        self.stats["warmup_background_pending"] = len(self._replay_queue) + self._deferred_inflight
        self.stats["warmup_replay_pending"] = len(self._replay_queue)

    def _pop_deferred(self) -> Optional[_GridKey]:
        with self._tick_lock:
            if not self._replay_queue:
                return None
            self._deferred_inflight += 1
            return self._replay_queue.popleft()

    def _run_replay_thunk(self, item: _GridKey) -> None:
        """Capture one deferred grid key on the device thread, then
        register it: dispatch may use it from the next tick on. Its warm
        run keeps live slots as they are (_WARM_IN_PLACE), and no replay
        follows the capture (it would step the live slots). A capture that
        fails is logged and counted in stats["warmup_capture_failures"],
        and its key stays unregistered: nothing runs it eagerly."""
        t0 = time.perf_counter()
        try:
            if self.device.type == "cuda":
                with torch.inference_mode():
                    self._ranks_do(lambda eng: eng.router.prepare(*item.entry(eng), replay=False))
            item.register()
        except Exception:
            logger.exception("deferred capture of %s failed", item.key)
            self.stats["warmup_capture_failures"] += 1
        finally:
            with self._tick_lock:
                self._deferred_inflight -= 1
            phases = self.stats.setdefault("warmup_phase_s", {})
            phases["deferred"] = round(phases.get("deferred", 0.0) + time.perf_counter() - t0, 3)
            self._note_deferred()

    def _drain_deferred(self, timeout: Optional[float]) -> None:
        """Capture the deferred keys still queued, in order, on the device
        thread (serialized with ticks), then wait for one an idle tick is
        capturing."""
        t0 = time.perf_counter()

        def time_left() -> bool:
            return timeout is None or time.perf_counter() - t0 < timeout

        while time_left():
            item = self._pop_deferred()
            if item is None:
                break
            self._device_thread().submit(self._run_replay_thunk, item).result()
        while self._deferred_inflight and time_left():
            time.sleep(0.002)

    def warmup_join(self, timeout: Optional[float] = None) -> None:
        """Return once no deferred key of a fast warmup is left (at once
        otherwise), or at the timeout: what the idle ticks have not
        captured yet is captured here (_drain_deferred)."""
        self._drain_deferred(timeout)

    def drain_replays(self, timeout: Optional[float] = None) -> float:
        """Capture every deferred key left, now; -> seconds spent. Benches
        call warmup_join() and this before measuring steady state; serving
        leaves them to the idle ticks."""
        t0 = time.perf_counter()
        self._drain_deferred(timeout)
        return time.perf_counter() - t0

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
        key = self._prefill_key(pool, ring, bucket, sb, B, P)
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

    @staticmethod
    def _prefill_key(pool: _CachePool, ring: bool, bucket: int, sb: int, B: int, P: int) -> tuple:
        return ("ring_prefill" if ring else "prefill", pool.name, bucket, B, sb, P)

    def _dual_fn(self, k: int):
        return functools.partial(_decode_k_dual_program, self.transcriber.params, self.cfg, k=k)

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
        return key, self._vad_host_program, self._bufs[key]

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
        ev.record(torch.cuda.current_stream(self.device))
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

    def eager_ok(self, stream_idx: Optional[int] = None) -> bool:
        """May a session launch an eager (speculative-endpoint) final now?
        (stream_idx: the asking session's ring row, which a data-parallel
        router routes by; one engine's gate is the same for every stream.)
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

    def eager_outcome(self, confirmed: bool, stream_idx: Optional[int] = None) -> None:
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

    def _run_tick_guarded(self, vad_batch, ring_vad_batch) -> None:
        """Executor entry of a tick. The busy count is the thread's own, so
        it holds even when the loop that dispatched a wedged tick has gone;
        start() refuses to spawn a scheduler while it is non-zero. A tick
        that outlived a crash may have admitted requests after the crash
        handler's sweep: it sweeps again on its way out, under the lock
        start() takes, so it cannot clear a scheduler that restarted."""
        with self._tick_lock:
            self._tick_busy += 1
        try:
            self._run_tick(vad_batch, ring_vad_batch)
        finally:
            with self._tick_lock:
                self._tick_busy -= 1
                if self._crashed:
                    self._fail_pending(RuntimeError("batcher crashed"))

    async def _await_tick(self, fut) -> None:
        """Wait for a tick on the executor. Past tick_stall_dump_s every
        thread's stack goes to stderr and the wait goes on; past
        tick_stall_abort_s this raises and the scheduler crashes. The stuck
        tick is abandoned, not stopped: a graph replay or an event
        synchronize wedged in the CUDA runtime cannot be cancelled, and
        only a process restart ends a lasting wedge."""
        try:
            await asyncio.wait_for(asyncio.shield(fut), self.tick_stall_dump_s)
            return
        except asyncio.TimeoutError:
            pass
        logger.error("scheduler tick stalled > %.1f s; dumping every thread's stack",
                     self.tick_stall_dump_s)
        faulthandler.dump_traceback(all_threads=True)
        waited = self.tick_stall_dump_s
        while True:
            try:
                await asyncio.wait_for(asyncio.shield(fut), self.tick_stall_dump_s)
                return
            except asyncio.TimeoutError:
                waited += self.tick_stall_dump_s
                if waited >= self.tick_stall_abort_s:
                    # retrieve the abandoned tick's outcome when it comes, so
                    # that nothing logs it as never retrieved
                    fut.add_done_callback(lambda f: f.cancelled() or f.exception())
                    raise RuntimeError(f"device tick wedged > {waited:.1f} s; abandoning the "
                                       "engine; restart the process")

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
                    await self._await_tick(loop.run_in_executor(
                        self._executor, self._run_tick_guarded, vad_batch, ring_vad_batch))
                self.stats["ticks"] += 1
                if not did_work:
                    item = self._pop_deferred() if self._replay_queue else None
                    if item is not None:
                        # fully idle: capture one deferred grid key on the
                        # tick thread, then look at the queues again
                        await loop.run_in_executor(self._executor, self._run_replay_thunk, item)
                        continue
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
        waits only on work it dispatched a tick earlier. With tick_trace on,
        one record of its phases' host times (the JAX package's keys)."""
        trace = self.tick_trace
        if trace is not None:
            self._trace_admit = {"prep_ms": 0.0, "write_ms": 0.0, "dispatch_ms": 0.0,
                                 "groups_short": 0, "groups_long": 0}
        t0 = time.perf_counter()
        self._sweep_cancelled()
        if self._stream_resets:
            self._reset_streams()
        if self._ingest_pending:
            self._scatter_ingest()
        t_ingest = time.perf_counter()
        if vad_batch:
            self._run_vad_batch(vad_batch)
        ring_vad_chunks = _chunked(ring_vad_batch, _VAD_BATCH_BUCKETS[-1])
        ring_vad = [(self._dispatch_vad_ring(c), c) for c in ring_vad_chunks]
        ring_vad = [(p, c) for p, c in ring_vad if p is not None]  # a failed one failed its futures
        t_vad = time.perf_counter()

        # admits; a starved pool with a waiting burst resolves the previous
        # tick first, to free its finished slots. Rationing admits the long
        # class after the short decode; the dual decode needs both admitted
        ration = self.ration_long_admits and not self.fuse_dual
        if self._ring_backlog or self._host_backlog:
            if self._pending_results is not None and self._any_pool_starved():
                self._resolve_pending()
            self._admit_backlogs(only=self.short if ration else None)
        else:
            self._backlog_has_short = False
        t_admit = time.perf_counter()

        # decode k steps per pool, short first. If every active slot has
        # surely run out its budget, resolve first instead of a wasted step
        early = self._pending_results is not None and self._all_surely_done()
        if early:
            self._resolve_pending()
        t_early = time.perf_counter()
        parked: list = []
        if self.fuse_dual:
            self._dispatch_decode_all(parked)
        else:
            if self.short.n_active > 0:
                self._dispatch_decode_pool(self.short, parked)
            if ration and (self._ring_backlog or self._host_backlog):
                self._admit_backlogs(only=self.long)
            if self.long.n_active > 0:
                self._dispatch_decode_pool(self.long, parked)
        t_decode = time.perf_counter()

        self._resolve_pending()
        t_resolve = time.perf_counter()
        if ring_vad or parked:
            self._pending_results = {"ring_vad": [p for p, _ in ring_vad],
                                     "ring_vad_batch": [c for _, c in ring_vad],
                                     "pools": parked}
        if trace is not None:
            trace.append({
                "t": t0,
                "ingest_ms": (t_ingest - t0) * 1e3,
                "vad_dispatch_ms": (t_vad - t_ingest) * 1e3,
                "admit_ms": (t_admit - t_vad) * 1e3,
                "early_resolve_ms": (t_early - t_admit) * 1e3,
                "decode_dispatch_ms": (t_decode - t_early) * 1e3,
                "resolve_ms": (t_resolve - t_decode) * 1e3,
                "total_ms": (t_resolve - t0) * 1e3,
                "early": early,
                "n_vad": len(vad_batch) + len(ring_vad_batch),
                # steps left after this tick's dispatch (0: surely done next tick)
                "remain_max": [(p.name, max(s.budget - 1 - s.steps_seen
                                            for s in p.slots if s.active))
                               for p in self.pools if p.n_active],
                "active": [(p.name, p.n_active) for p in self.pools],
                "admit_detail": self._trace_admit,
            })

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

            def scatter(eng, M=M, packed=packed, stream_idx=stream_idx, chunk_ids=chunk_ids):
                key, fn, bufs = eng._scatter_entry(M)
                eng._put_all(bufs, packed=packed, stream_idx=stream_idx, chunk_ids=chunk_ids)
                eng.router.run(key, fn, bufs)

            self._ranks_do(scatter)
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

    def _admit_backlogs(self, only: Optional[_CachePool] = None) -> None:
        """Route backlogged requests to their pools (to `only`'s alone when
        given), shortest budget first; admit what fits each pool's free
        slots and carry the rest. While the short class is busy, long
        admissions are paced (busy_long_admit_cap per tick)."""
        scope = self.pools if only is None else (only,)
        free = {id(p): p.free for p in scope}
        if id(self.long) in free and not self._short_quiet():
            free[id(self.long)] = min(free[id(self.long)], self.busy_long_admit_cap)
        # the call that routes the short class owns the waiting-interim flag
        track_short = only is None or only is self.short
        if track_short:
            self._backlog_has_short = False
        for backlog, route, admit in ((self._ring_backlog, self._ring_pool,
                                       self._admit_ring_grouped),
                                      (self._host_backlog, self._host_pool, self._admit_grouped)):
            if not backlog:
                continue
            keep, take = [], {}
            for req in sorted(backlog, key=lambda r: r.max_new_tokens):
                pool = route(req)
                if free.get(id(pool), 0) > 0:
                    free[id(pool)] -= 1
                    take.setdefault(id(pool), []).append(req)
                else:
                    keep.append(req)
                    if track_short and pool is self.short:
                        self._backlog_has_short = True
            backlog[:] = keep
            for pool in scope:
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
        ta, t_w = self._trace_admit, time.perf_counter()
        try:
            slot_bias = [(s, self._hotword_ids(r.hotwords)) for s, r in zip(slot_list, items)]
            draft_rows, draft_lens = self._prep_draft_rows(
                pool, [(s, r.draft_tokens) for s, r in zip(slot_list, items)], B)
            t_d = [0.0]  # rank 0's program dispatch

            def admit(eng):  # on every rank, its own pool of that name
                rp = eng._pool(pool.name)
                eng._set_slot_bias(rp, slot_bias)
                key, fn, bufs = eng._prefill_entry(rp, True, bucket, sb, B, len(prefix))
                eng._put_all(bufs, prefix_ids=prefix, stream_idx=stream_idx, start_chunk=start,
                             chunk_count=count, suffix_ids=suffixes, suffix_lens=suffix_lens,
                             slots=slot_list + [rp.trash_slot] * (B - len(items)),
                             budget_vals=budgets, draft_rows=draft_rows, draft_lens=draft_lens)
                if eng is self:
                    t_d[0] = time.perf_counter()
                eng.router.run(key, fn, bufs)

            self._ranks_do(admit)
        except Exception as e:
            self._fail_group(items, e)
            return
        if ta is not None:
            self._trace_group(ta, pool, t_w, t_d[0])
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

    def _mel(self, req: _TranscribeReq):
        """-> (bucket, the log-mel kernel's mel [bucket, n_mels] on this
        engine's card, frames) of a host request's audio."""
        tr = self.transcriber
        x = tr.prepare_audio(req.audio, req.sample_rate)
        frames = max(1, frame_count(int(x.shape[0]), tr.mel_cfg))
        bucket = tr._pick_bucket(frames)
        if frames > bucket:
            frames = bucket
            x = x[: bucket * tr.mel_cfg.hop_length]
        return bucket, log_mel_spectrogram(x, tr.mel_cfg, pad_to_frames=bucket).to(tr.dtype), frames

    def _prepare_request(self, req: _TranscribeReq):
        """Host request -> (bucket, mel [bucket, n_mels] on the device,
        frames, prefix, suffix [sb], suffix_len, sb), or None if it failed
        (its future gets the error). The mel is the log-mel kernel's."""
        tr = self.transcriber
        try:
            bucket, mel, frames = self._mel(req)
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

    def _trace_group(self, ta: dict, pool: _CachePool, t_write: float, t_dispatch: float) -> None:
        """Add an admitted group to the traced tick's admit detail: its
        input writes (bias rows, drafts, host-to-device copies) from
        t_write, its program's dispatch from t_dispatch to now."""
        ta["write_ms"] += (t_dispatch - t_write) * 1e3
        ta["dispatch_ms"] += (time.perf_counter() - t_dispatch) * 1e3
        ta[f"groups_{pool.name}"] += 1

    def _admit_grouped(self, pool: _CachePool, reqs: list[_TranscribeReq]) -> None:
        """Prepare each request, group by (mel bucket, suffix bucket), one
        prefill program per group of a registered size."""
        by_key: dict = {}
        t_prep = time.perf_counter()
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
        if self._trace_admit is not None:  # host prep: resample, mel dispatch, prompt
            self._trace_admit["prep_ms"] += (time.perf_counter() - t_prep) * 1e3
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
        ta, t_w = self._trace_admit, time.perf_counter()
        try:
            slot_bias = [(s, self._hotword_ids(r.hotwords)) for s, (r, _) in zip(slot_list, items)]
            draft_rows, draft_lens = self._prep_draft_rows(
                pool, [(s, r.draft_tokens) for s, (r, _) in zip(slot_list, items)], B)
            reqs = [r for r, _ in items] + [items[0][0]] * pad
            t_d = [0.0]  # rank 0's program dispatch

            def admit(eng):  # on every rank, its own pool of that name
                rp = eng._pool(pool.name)
                eng._set_slot_bias(rp, slot_bias)
                key, fn, bufs = eng._prefill_entry(rp, False, bucket, sb, B, len(preps[0][3]))
                # each rank makes the mels from the host audio on its card: a
                # copy across cards would order one card's stream after the
                # other's, and rank 0's prefill all-reduces could then wait
                # for a rank whose copy waits for them
                bufs["mels"].copy_(torch.stack([p[1] for p in preps] if eng is self
                                               else [eng._mel(r)[1] for r in reqs]))
                eng._put_all(
                    bufs, prefix_ids=preps[0][3],
                    n_frames=[p[2] for _, p in items] + [bucket] * pad,
                    suffix_ids=np.stack([p[4] for p in preps]),
                    suffix_lens=[p[5] for p in preps],
                    slots=slot_list + [rp.trash_slot] * pad,
                    budget_vals=[r.max_new_tokens for r, _ in items] + [0] * pad,
                    draft_rows=draft_rows, draft_lens=draft_lens)
                if eng is self:
                    t_d[0] = time.perf_counter()
                eng.router.run(key, fn, bufs)

            self._ranks_do(admit)
        except Exception as e:
            self._fail_group([r for r, _ in items], e)
            return
        if ta is not None:
            self._trace_group(ta, pool, t_w, t_d[0])
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
        if self._warmed and (k, None) not in pool.compiled_decode:
            # a fast boot registers the long pool's escalation rungs later:
            # the largest registered rung below k until then (never a
            # capture on a request's path)
            reg = [c for c in choices if (c, None) in pool.compiled_decode]
            if reg:
                k = next((c for c in reversed(reg) if c <= k), reg[0])
        return k

    def _pick_rows(self, pool: _CachePool, k: int) -> Optional[int]:
        """The smallest registered rows rung covering every active slot; None
        = the full pool."""
        high = max((i + 1 for i, s in enumerate(pool.slots) if s.active), default=0)
        return next((r for r in pool.rows_ladder
                     if r >= high and (k, r) in pool.compiled_decode), None)

    def _dispatch_decode_all(self, parked: list) -> None:
        """Every active pool's decode (fusion on). With both pools active,
        one dual program: its k is the short pool's pick (clamped to the
        dual ladder), so the interim class finishes in one tick and the
        long pool rides along; the long pool's drafted slots take plain
        steps in it (no verify program), as in the JAX package. After a
        warmup only a registered dual k runs; else the pools decode apart."""
        active = [p for p in self.pools if p.n_active > 0]
        k = min(self._pick_k(self.short), self.dual_k_choices[-1]) if len(active) == 2 else None
        if k is None or (self._warmed and k not in self._compiled_dual):
            for pool in active:
                self._dispatch_decode_pool(pool, parked)
            return
        self._ranks_do(lambda eng: eng.router.run(("decode_dual", k), eng._dual_fn(k),
                                                  eng._dual_bufs))
        self._compiled_dual.add(k)
        self.stats["dual_decodes"] += 1
        self._park(self.short, k, parked)
        self._park(self.long, k, parked)

    def _dispatch_decode_pool(self, pool: _CachePool, parked: list) -> None:
        """Pick k and rows, replay the pool's decode program (or, with a
        drafted slot live, its verify program for some rounds) and park its
        status and token rows."""
        k = self._pick_k(pool)
        rounds = self._pick_verify_rounds(pool, k)
        if rounds is not None:
            rows = self._pick_verify_rows(pool, rounds)
            self._ranks_do(lambda eng: eng.router.run(eng._verify_key(pool, rounds, rows),
                                                      eng._verify_fn(rounds, rows),
                                                      eng._pool(pool.name).state))
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
        self._ranks_do(lambda eng: eng.router.run(("decode", pool.name, k, rows),
                                                  eng._decode_fn(k, rows),
                                                  eng._pool(pool.name).state))
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
        verify_rounds_choices on an engine never warmed; None on a warmed
        one until a verify program is registered), capped at k (a round
        costs about a decode step). The short pool never verifies:
        warmup registers no verify program there, so a drafted short
        request takes the plain ladder, as on a warmed JAX engine (an
        unwarmed one would build a short-pool verify program on demand)."""
        if (not self.speculative or pool is not self.long
                or not any(s.active and s.drafted for s in pool.slots)):
            return None
        choices = sorted({r for r, rows in pool.compiled_verify if rows is None})
        if not choices:
            if self._warmed:
                return None  # a fast boot registers the verify grid later
            choices = sorted(self.verify_rounds_choices)
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
