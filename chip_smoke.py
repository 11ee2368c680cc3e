#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sonicscribe_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package. Phases, each of which
exits non-zero on failure:

1. build: nvcc compiles every kernel of csrc/ for sm_90a, in parallel.
   Then weights quantized on the card against the same weights quantized
   on the CPU at nano's projection shapes: the script counts the columns
   whose scale or codes differ with the old `/ 127.0` (PyTorch's CUDA
   division by a Python scalar multiplies by the reciprocal) and with
   quantize_tensor, which must give none.
2. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the main path's shapes, with its stated tolerance (decode attention
   also at lens on either side of a split boundary, and two launches on the
   same inputs must give the same bits; verify attention, its W1-query
   form, at S 1, 4 and 33, M 803, W1 9 and 1, lens past M - W1 at S 33,
   each bf16 W1 9 launch on the tensor-core kernel, and at W1 1 equal, bit
   for bit, to decode attention); then its time
   beside its plain version's, a PyTorch library call's (a yardstick the
   port never calls) and its bound at the H100's 3.35 TB/s and its peak
   rate for the work's type (NVIDIA data sheet, SXM): 67 TFLOP/s float32
   on the CUDA cores for decode attention (verify attention: 989 TFLOP/s
   bf16 on the tensor cores, which run its products, with the float32
   figure printed beside, and its float32 form timed alone); for the mel
   the lesser of that
   and three passes at 495 TFLOP/s TF32 (its 3xTF32 DFT), both printed;
   989 TFLOP/s bf16 and 1979 TOP/s int8 on the tensor cores for the int8
   and int4 products (W8A16, W4A16 and W8A8, W4A8), which the tensor cores
   can run. The mel kernel is checked at every bucket and on a quiet-then-
   loud signal in both frame tiles (16 and 32), and timed at 1200 and 3072
   frames in both. The int8
   kernels are checked at nano's decode shapes (B 1, 2, 4, 5 and 8: qkv, o,
   gate_up, down; the stacked W8A16 kernel also for equal bits over two
   runs), prefill rows (B 419: qkv, down) and encoder rows (B 1536: fc1,
   fc2), x in float32 and bf16, and the flat and stacked entries'
   tensor-core design (bf16, B > 8) also at B 9, 17 and 227 on the four
   decoder projections;
   W8A8 quantises x in its own kernels and is held to the plain version run
   on CPU copies of the inputs (the JAX recipe), bit for bit, at B 1, 2, 4,
   5, 8 and either side of W8A8_MMA_MIN_ROWS, crafted rows included, under
   the entry and both designs forced (two runs equal bits; the
   int8_matmul_w8a8_mma counter rising exactly from the threshold); a
   profile of one stacked W8A16 call and of one W8A8 call at B 1 must each
   show one kernel, and of a W8A8 call at the threshold and at 64 rows only
   W8A8 kernels; W8A8 is timed at B 1 on the four projections and at gate_up
   B 8, 37 and 64 (torch._int_mm its yardstick above 16 rows, bf16
   torch.mm on the dequantised weight below; W4A8 the same), with its
   cluster sizes at B 1, 2 and 4 and both designs at the four projections
   from 1 to 256 rows (the threshold's A/B); the flat W8A16 design is timed at the four
   prefill/encoder shapes beside the cluster split-K design on the same
   inputs; the four int4 kernels at nano's decode
   shapes (B 1, 2, 4, 5, 8, 9, 16, 17, 37, 64, 227, and W4A8 crafted rows),
   flat and stacked, each tensor-core counter rising exactly where
   w4a16_uses_mma / w4a8_uses_mma say. W4A8 is held to the plain version run
   on CPU copies, and the script counts the rows where the old `/ 127.0`
   on the card changes sx (and checks that quantize_activations never
   does); a profile of two W4A8 calls must show only int4_matmul.cu's
   kernels, and at B 1 and 4 the W4A8 tensor-core design is timed beside the
   dispatched CUDA-core one on the same inputs (equal bits). Both W4A16
   designs are timed on the same inputs at the four decode projections, B
   1-5, 8 and 9, and gate_up also at 16, 37 and 64 (the threshold's A/B).
   The int4 kernels are timed at B 1 and at gate_up B 64 (W4A8 also at
   gate_up B 8 and 37). Then the bench tools' per-step projection sweeps:
   int8 at B 1, 8 and 64; int4 at B 1, 8 and 64 in every variant, after one
   eager step of each int4 kernel variant whose launches are counted (4 per
   layer) and whose output is held against the int8 variant's on the same
   codes; and the cluster split-K design's slice tables (half, shipped and
   twice CLUSTER_ROWS_PER_CTA, and W8A8's own) timed in a replayed int8,
   int8_w8a8 and int4_w4a16 step.
   The int4 kernels serve no request: the JAX package serves no int4 mode,
   and its only path to them is this sweep.
   micro: the decode microbenches' legs at full width (nano bf16, 28
   layers), MICRO_REPS timed programs a leg: tools/bench_hbm's five
   arrays (each rate above 0 and at most the data sheet's x 1.05);
   bench_decode_parts' four parts and the full step's split by op (the op
   groups cover at least MICRO_COVERAGE of the profiled busy time, and the
   profile holds one decode-attention split kernel per layer and step);
   bench_decode at 50 x 896, captured and eager; bench_rows at rows 4 and
   full (float32 parity: the same tokens, the rows past the prefix
   untouched), then bf16 timing; bench_flash at occupancies 64 and
   max_len - 8 on both routes (the routes' attention within
   bench_flash.AGREE_TOL of each other). Every time above 0. A line
   `micro {...}` holds the twins' results.
3. main path: build_runtime("nano-random", engine_kind="threaded") in bf16
   at full width; its transcriber's CUDA graphs captured for every bucket
   and the budgets 15,
   200 and 256 (engine.warmup: one decode graph per budget ceiling; the
   time of each key and of the grid, graphs, memory with the grid warmed);
   then the file-transcription path of POST
   /transcribe/file (decode_audio + transcribe_file_stream) on three 16 kHz
   WAVs made from a seed: ~3 s, ~12 s and ~35 s with silences (VAD splits
   it, one span is cut long). Each request runs captured (the main path:
   graph replays), and the ~3 s and ~12 s ones also eager (an engine of
   this script whose transcriber runs assemble_prompt + greedy_generate op
   by op on the same weights; the ~35 s one no longer, for the script's
   time): tokens equal (a difference fails and prints its step and both
   tokens' eager logits), wall, RTF, decode tokens/s, peak memory,
   and from a profiled run at a 32-token budget the device busy time and
   idle share. The launch counters are set to 0 before each request and
   read after: the mel kernel must have run once per segment and decode
   attention once per layer per decode step (replays counted by the
   router). Then, in
   each int8 mode (int8, int8-decoder, int8-decoder-a8), a runtime of its
   own, cut to its first INT8_THREADED_LAYERS (7) decoder layers for the
   script's time, with its grid captured serves the ~3 s and ~12 s
   requests captured and eager in the same way: the stacked W8A16 kernel (W8A8 in -a8) runs 4
   times per layer per decode step (one launch each), the flat W8A16
   kernel 4 times per layer per segment in prefill (plus 6 per encoder
   layer in full int8), every one of them bf16 with B > 8 and so on the
   tensor cores (int8_matmul_mma), and W8A8's one decode row on its
   cluster design; in -a8 the eager profile shows one W8A8 kernel per W8A8
   call (the captured one too where the profiler itemizes a replayed
   graph's kernels).
   The stream: on that runtime, one StreamSession (serve/session.py, the
   /ws/audio session, driven without aiohttp) on ThreadedEngine receives
   2048-byte PCM16 frames at real-time pace, 64 ms each, of ~42 s of
   speech and silence (4 s, 9 s and 22 s of speech: two eager finals and a
   final over max_segment_duration committed as _part_0 and _part_1). The
   launch counters are set to 0 before it and read after. Checks: the
   committed segments and parts are the ones the gate implies on
   window_probs of the same samples; no graph is captured during the
   stream (every budget runs on its ceiling's graphs); each committed text
   is a standalone Transcriber.transcribe of the same audio at the same
   budget (the same graphs, the same bits); each VAD window's probability
   is the max of window_probs over its samples within 1e-6; log_mel once
   per interim and final; decode attention once per layer per decode step;
   no call failed. A line `stream {...}` holds its numbers: interims sent
   and dropped, tentative delay, speech-end -> committed latency, the VAD
   window's time on the device thread and its wait there, memory, the
   grid.
4. reference: tiny() in float32 gives the same tokens on the card (graph
   replays) as on the CPU (where the tests hold it against the JAX
   package), natively and in each int8 mode (each tree quantized on its
   own device, as build_runtime quantizes it), with 1 and 8 decode steps
   per graph and a budget of 21 (on ceiling 200's graphs); a tiny f32
   StreamSession on the card sends the messages of one on the CPU (a
   stepped clock, each VAD window awaited); tiny graphs captured while
   another thread resamples uploads on the card give the tokens of graphs
   captured alone; and nano's prefill logits are finite. Then tiny f32 on
   the batched engine: five concurrent requests (mixed budgets, hotwords)
   give the same tokens on the card (warmup's graphs) as on the CPU; a
   request undrafted and with a golden, a half-garbage and a garbage draft
   gives the same tokens every time, on the card as on the CPU, with the
   same verify rounds; and a stepped StreamSession on the ring the same
   messages. On a tiny engine built with fuse_dual_decode: a fast boot
   (a request before its deferred keys land and after the drain: equal
   tokens, nothing captured on the request path), the dual decode (short
   and long requests at once: fused tokens equal unfused ones, dual
   decodes counted), and a crash and its heal (a 2 s wedged tick past a
   0.3 s abort: the request fails, alive False, start() refused while the
   tick is stuck, then the pre-crash tokens and no graph captured again);
   then warmup(full=True)'s graphs against the default grid's.
5. batched: the kernels at the batcher's shapes first (after phase 2):
   decode attention at S 33, M 803 and S 65, M = the short pool's length,
   lens mixed with empty slots; the log-mel kernel over a batch of rows in
   one launch (B 1, 4, 32 x 128 frames, B 4 x 3072), each row normalized
   on its own; the stacked W8A16 entry at 16, 33 and 65 rows and W8A8 at
   4, 16, 33 and 65 against their plain versions; with times. Then, in
   native and in int8-decoder-a8 (cut to its first BATCHED_INT8_LAYERS (7)
   decoder layers for the script's time), build_runtime's default engine (the
   continuous batcher, engine/batcher.py): its grid captured (graphs,
   seconds by kind, memory; the 12 verify keys, rounds 1, 2, 4, 8 x rows
   full, 1, 4, among them), in native by a fast boot (warmup(fast=True):
   the blocking seconds, graphs and peak memory; the ~12 s request served
   first while the deferred keys wait, nothing captured on its path; then
   warmup_join and drain_replays: seconds, peak memory, no capture failed,
   the registered grid _grid()'s), the engine built with fuse_dual_decode
   (its dual graphs in the grid, fusion off until the A/B) and the tick
   trace on; the ~3 s, ~12 s and ~35 s requests submitted
   at once through the file path (walls, RTF, aggregate tokens/s, peak
   memory; tokens beside phase 3's threaded ones, the first divergence
   printed); the ~12 s request undrafted, then with its own tokens, its
   first half then garbage, and garbage as drafts (speculative finals: wall,
   tokens/s, verify rounds, spec_accept_ema; the golden draft must take
   verify rounds, no graph may be captured; the first divergence from the
   undrafted tokens printed); then 8 StreamSessions on the device ring,
   real-time frames of STREAM_SPANS 0.25 s apart, beside the ~12 s file
   request: each commits what the gate implies, no graph is captured, no
   call fails (tentative delay, speech end -> committed, interims sent and
   dropped, the ring VAD program's time; eager finals launched and gated
   by eager_ok, verify rounds, the acceptance EMA; in native the p50 and
   p95 of each traced tick phase); in native, 1, 4, 16 and 32 concurrent
   requests at a 128-token budget (wall, tokens/s, and at 1 and 32 a profiled run's
   device busy and idle share), then the dual decode's A/B on the same
   engine: the three files and 16 interim-budget requests at once,
   unfused then fused, timed and profiled (walls, tokens/s, dual decodes,
   device busy per pool step; decode attention once per layer per pool
   step, two launches a dual step). No run after the fast boot captures a
   graph on the request path. The launch counters are set to 0 before the files, the
   drafted runs and the streams, and read after: log_mel once per
   prepared host request and per ring prefill program, decode attention
   once per layer per plain pool decode step, verify attention once per
   layer per verify round, every one on the tensor cores
   (verify_attention_mma); over both modes W8A8 ran in both designs.
   Last, in native, the load phase on the same warmed engine:
   tools/loadtest.run_load drives LOAD_STREAMS (50) realtime sessions for
   LOAD_SECONDS (12) s of its speech / silence cycles (2.0 / 1.5 s, the
   energy gate, speculative and eager finals on from fresh gates), the
   launch counters set to 0 just before and read just after: no error, at
   least a commit a stream, no graph captured on the request path, decode
   attention, log_mel and verify attention launched. A line `load {...}`
   holds run_load's dict, the device round trip and capture probes, the
   short and long classes' queue / run p50 and p95, the sessions on the
   host path, the traced tick phases and the phase's seconds.

6. silero: the Silero VAD and the checkpoint tools on the card. A seeded
   Silero tree on the card against the same tree on the CPU over one gate
   window (20 sub-windows) at B 1, 16 and 64 (probabilities and states
   within 1e-5) and over the 35 s file (window_probs within 1e-4, timed);
   the independent twin (tools/torch_silero.py, upstream names, plain
   torch modules): its state dict through the port's converter into
   SileroVad, whose probabilities over the ~12 s file are held to the
   twin's on the card within 1e-4;
   tiny f32 batched engines built with SileroCostProbeVad and with
   EnergyVad, each warmed: 8 stepped streams capture no graph on the
   request path and commit the same segments, and their ring VAD programs
   are replayed and timed at B 16 and 64; the threaded engine's Silero
   gate window timed. Then the checkpoint path at nano's widths, encoder
   and decoder cut to 2 layers: export_hf_checkpoint of a seeded bf16
   tree as BF16 safetensors, convert_hf_checkpoint, load_checkpoint onto
   the card (the tree's bits), the ~12 s request's tokens from the loaded
   tree equal to the in-memory tree's, and verify_checkpoint on the card
   (its report printed; no step fails, the twin passes); the GB and
   seconds of each step.

7. dp: data-parallel serving (engine/replicas.py) on two replicas:
   cuda:0 and cuda:1 where the machine has two cards, else cuda:0 twice
   (printed first). Tiny f32: each replica's slots, ring and weights on
   its card; 8 concurrent host requests give one engine's tokens; 4 ring
   streams spread over the replicas give the host path's tokens on their
   int16 audio; each replica's decode steps and decode-attention launches
   (its router's replays) above 0; parallel/dryrun.py's dry run over the
   same cards (its dp x tp leg where they are two cards). Then nano bf16 at full width (build_runtime with
   DATA_PARALLEL=2 on two cards; the same engine by hand on one), each
   replica fast-booted and its deferred keys dropped, and
   tools/loadtest.run_load with 50 realtime streams for 12 s: no error, a
   commit a stream at least, streams on both replicas, no graph captured
   on the request path, each replica decoding; the latencies, each
   replica's share of the streams and the memory are printed (`dp {...}`).
8. tp: tensor parallelism (parallel/tp.py, parallel/mesh.py:
   shard_params_tp, the dp x tp engine of engine/replicas.py). The card
   count picks the leg, and the phase's first line prints it. On both: the
   kernels at nano's tp = 2 shard shapes on the card against their plain
   versions (decode attention over a rank's 8 query and 2 KV heads at S 1
   and 32, timed; verify attention over them; the stacked W8A16 entry on
   each projection's shard at 1 and 32 rows, the flat one at 419 prefill
   rows). Two cards or more, the engine leg (NCCL, captured): tiny f32 over
   a 1 x 2 mesh (2 x 2 on four cards) against one engine: 8 host requests,
   a drafted final and 4 ring streams give its tokens, each rank's shards,
   pools and ring on its card, each rank's decode-attention launches and
   all-reduces above 0, no capture on the request path, the followers'
   slots equal to rank 0's; nano bf16 at tp = 2 on two cards: each rank's
   resident weight GiB, a captured decode step at 1 and 32 rows against
   one card's in the same run (logits within TP_LOGIT_TOL of max|logits|,
   device ms both ways, the 56 all-reduces' ms alone, capture seconds by
   rank), and the ~12 s request through the file path on the dp x tp
   engine (wall); nano int8 at tp = 2: the ~3 s request, the stacked W8A16
   kernel 4 times per layer, step and rank; nano int8-decoder-a8 at tp =
   2: the captured step at 1 and 32 rows against its one-card step and
   native tp's, its all-reduces a step (56 sums + 56 maxima of the rows'
   max|x|) and the 56 max-reduces' ms alone, the ~3 s request (W8A8 4
   times per layer, step and rank) and a drafted final. One card: both
   ranks' shards of a nano decode step at 32 rows on cuda:0, each on its
   thread, the partials added (and the row maxima taken) in rank order,
   native, int8-decoder and int8-decoder-a8, against the card's
   whole-tree step (the same tolerance); it prints that the engine leg
   needs two cards (`tp {...}`). Both legs hold W8A8 with a given
   row_amax to its plain version at the shard shapes, bit for bit, and
   without one at the whole shapes.
9. prewarm: tools/prewarm.py --model tiny-random --out <tmp> copies the
   kernel and native libraries this run built (the same bytes, nothing
   built); a child process with SONIC_KERNEL_DIR on that directory serves
   one tiny request on the card and must build nothing, load its
   libraries prebuilt and launch the log-mel and decode-attention kernels
   (`prewarm {...}`).
10. resilience: tools/bench_resilience.py's wait_for_device with its
   default probe (a child interpreter's round trip on the card) must
   answer at the first probe; run_phase on a child that writes JSON gives
   "ok", on one that exits 7 "crashed" (`resilience {...}`).

A line `captured {...}` holds phase 3's numbers by mode (grid, requests
eager and captured), `batched {...}` phase 5's, `silero {...}` phase 6's
(it runs after phase 4, before the batched modes). The line before the last
is the kernels' JSON record (ten kernels, each with the path its
launches were counted on (verify attention: the drafted runs of phase
5), decode attention and log_mel also with their launches on the stream
(`stream_launches`; verify attention: the batched streams'), every one with its launches
on the batched paths (`batched_launches`), decode attention, log_mel and the
stacked W8A16 and W8A8 entries also with
their batched shapes' numbers (`batched_shapes`), every one with its
launches in the load phase (`load_launches`), in the dp phase's load
(`dp_launches`) and in the tp phase's runs (`tp_launches`); the redesigned ones with
their design; the flat W8A16, W8A8 and the four int4 entries with
`mma_launches`, the launches that took the tensor cores, verify attention
with `mma_launches` of its drafted runs); the last line is
{"ok": true, "device": {...}}. Without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import asyncio
import gc
import json
import logging
import os
import subprocess
import sys
import threading
import time

import numpy as np

SR = 16000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM, TF32 tensor cores, dense
BF16_FLOPS_PER_S = 989e12  # H100 SXM, bf16 tensor cores, dense
INT8_OPS_PER_S = 1979e12  # H100 SXM, int8 tensor cores, dense
ATTN_TOL = 2e-5  # same inputs, float32 sums in another order
MEL_TOL = 1e-3  # normalized log-mel; float32 DFT sums in another order
# W8A16 and W4A16: float32 sums in another order, at most this share of
# max|want|; in bf16 one more bf16 ulp of want for the final rounding.
# W8A8 and W4A8: equal.
INT8_F32_TOL = 1e-5
# an int4 sweep step against the int8 step on the same codes, as a share of
# max|int8 step|: bf16 roundings in another order, and in W4A8 the per-row
# activation quantisation, over 28 layers
SWEEP_TOL = 0.02
INT8_MODES = ("int8", "int8-decoder", "int8-decoder-a8")
# decoder layers of the threaded int8 main paths (nano has 28): their
# requests run captured and eager, and this depth keeps the script inside its
# time limit; every other path runs all 28
INT8_THREADED_LAYERS = 7
BATCHED_INT8_LAYERS = 7  # int8-decoder-a8's batched phase runs this deep (the script's time)
SEED = 0
GRID_BUDGETS = (15, 200, 256)  # the interim, final maximum and file budgets (config.py)
PROFILE_BUDGET = 32  # decode tokens per segment in the profiled runs
PROFILE_TRIES = 6  # profiles of a request at most, while records are missing
# profiles of a few calls at most, while empty: one costs milliseconds, and
# the H100 has returned three empty ones in a row
KERNEL_PROFILE_TRIES = 20
# the batched phase: its modes, realtime streams, their staggered starts,
# and the active long slots of the profiled decode runs (at a budget)
BATCHED_MODES = ("native", "int8-decoder-a8")
BATCHED_STREAMS = 8
LOAD_STREAMS = 50  # the north star's concurrent realtime streams
LOAD_SECONDS = 12.0
STREAM_STAGGER_S = 0.25
TICK_SLOTS = (1, 4, 16, 32)
# the counts of TICK_SLOTS whose run is also profiled: the ends of the range
TICK_PROFILED = (1, 32)
TICK_BUDGET = 128
# the micro phase: timed programs a leg (the twins' own runs take 8-20),
# HBM reads an array, and the share of the step's busy time its op groups
# must cover
MICRO_REPS = 3
MICRO_HBM_REPS = 10
MICRO_COVERAGE = 0.95
VERIFY_W1 = 9  # the batched engine's spec_w + 1: query positions of a verify round
VERIFY_M = 803  # the long pool's cache length at nano
# each captured request's segment tokens on the threaded engine, by (mode, request)
THREADED_TOKENS: dict = {}
# a profile's kernels by part of the model, by name
KERNEL_PARTS = {
    "attention": ("decode_attention", "verify_attention"),
    "projections": ("nvjet", "gemm", "splitk::", "w8a16", "w8a8", "cutlass", "sm90_xmma"),
    "elementwise": ("at::native",),
    "other": (),
}


def fail(msg: str) -> None:
    # on both streams: a caller that keeps only the end of stderr sees why
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(*args) -> None:
    print(*args, flush=True)


def speech(sec: float, seed: int) -> np.ndarray:
    """Speech-like test signal: four partials under a 3 Hz envelope + noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * sec)) / SR
    env = 0.5 * (1 + np.sin(2 * np.pi * 3 * t))
    x = 0.25 * env * sum(np.sin(2 * np.pi * f * t) for f in (200, 700, 1500, 2600))
    return (x + 0.002 * rng.standard_normal(len(t))).astype(np.float32)


def silence(sec: float, seed: int) -> np.ndarray:
    return (0.0006 * np.random.default_rng(seed).standard_normal(int(SR * sec))).astype(
        np.float32
    )


class Timer:
    """Median device time of a call, each launch timed with CUDA events
    after the L2 cache is overwritten (the main path reaches these kernels
    with the cache full of other layers' weights). A spin kernel ahead of
    each start event keeps the card busy while the host enqueues the call,
    so host-side launch cost is not counted as device time."""

    SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's boost clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 30) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def check_w16(torch, name, got, want, case) -> float:
    """A W8A16 or W4A16 kernel's output against its plain version: within
    INT8_F32_TOL of max|want|, plus one bf16 ulp of want in bf16. -> the
    max abs err."""
    want32 = want.float()
    err = (got.float() - want32).abs()
    tol = INT8_F32_TOL * want32.abs().max()
    if want.dtype == torch.bfloat16:  # one bf16 ulp of want for the rounding
        tol = tol + torch.exp2(torch.floor(torch.log2(want32.abs().clamp(min=2.0**-126))) - 7)
    check(got.dtype == want.dtype and bool(torch.isfinite(got).all())
          and bool((err <= tol).all()), f"{name} {case}: max err {err.max().item()} "
          f"beyond its tolerance")
    return err.max().item()


def bound_ms(n_bytes: float, flops: float, peak: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def profiled(torch, fn, tries: int = PROFILE_TRIES):
    """fn() under torch.profiler (CUDA activity). fn launches at least one
    kernel, so a profile with no kernel record lost its records (the
    profiler has returned empty profiles on the H100, also after earlier
    profiles of the process had records): fn is run and profiled again, at
    most `tries` times. -> (the profile, fn's result)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            break
        log("an empty profile; profiling again")
    return prof, out


def kernel_names(torch, fn) -> list[str]:
    """The kernels one call of fn runs on the card (built and loaded first)."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    prof = profiled(torch, fn, KERNEL_PROFILE_TRIES)[0]
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def kernel_phase(torch, timer):
    import torch.nn.functional as F

    from sonicscribe_tpu_torch.audio.mel import (
        MelConfig,
        device_tables,
        normalize_log_mel,
        reflect_pad,
    )
    from sonicscribe_tpu_torch.models.config import nano
    from sonicscribe_tpu_torch.ops import _build
    from sonicscribe_tpu_torch.ops.decode_attention import (
        decode_attention_cuda,
        decode_attention_plain,
        split_shape,
    )
    from sonicscribe_tpu_torch.ops import mel as tmel
    from sonicscribe_tpu_torch.ops.mel import (
        FRAMES_PER_BLOCK,
        frames_per_block,
        log_mel_frames_cuda,
        log_mel_frames_plain,
    )

    dec = nano().decoder
    nh, nkv, hd = dec.n_heads, dec.n_kv_heads, dec.head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def cache(S, M, dtype):
        # one layer of a [2, S, M, nkv, hd] cache: the strided view decode_step passes
        k = torch.randn((2, S, M, nkv, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((2, S, M, nkv, hd), generator=gen, device="cuda").to(dtype)
        q = torch.randn((S, nh, hd), generator=gen, device="cuda").to(dtype)
        return q, k[1], v[1]

    # ---- decode attention: correctness at nano heads ----
    n_sms = _build.n_sms(torch.device("cuda"))
    attn_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for S in (1, 4):
            for M in (675, 803, 1024):
                q, k, v = cache(S, M, dtype)
                # a slot sees lens + 1 positions: lens chunk - 1 fills the
                # first split exactly, chunk starts the second
                chunk, _ = split_shape(S, M, nkv, n_sms)
                cases = [[L] * S for L in sorted({0, 1, 127, 128, chunk - 2, chunk - 1, chunk,
                                                  2 * chunk - 1, M - 1, M, M + 5})]
                if S == 4:
                    cases += [[0, 127, 128, M - 1], [chunk - 1, chunk, 2 * chunk, M]]
                for lens_list in cases:
                    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
                    got = decode_attention_cuda(q, k, v, lens)
                    want = decode_attention_plain(q, k, v, lens)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    check(np.isfinite(err) and err <= ATTN_TOL,
                          f"decode_attention {dtype} S={S} M={M} lens={lens_list}: "
                          f"max err {err} > {ATTN_TOL}")
                    attn_err = max(attn_err, err)
        q, k, v = cache(4, 1024, dtype)
        lens = torch.tensor([5, 300, 677, 1023], dtype=torch.int32, device="cuda")
        check(torch.equal(decode_attention_cuda(q, k, v, lens), decode_attention_cuda(q, k, v, lens)),
              f"decode_attention {dtype}: two launches on the same inputs differ")
    log(f"decode_attention: max abs err {attn_err:.3g} <= {ATTN_TOL} (f32 and bf16 caches, S in "
        f"1,4, M in 675,803,1024, lens 0,1,127,128,M-1,M,M+5 and on either side of the first "
        f"two split boundaries); two launches give equal bits in f32 and bf16")

    # ---- decode attention: time at main-path shapes (bf16, batch 1) ----
    # M = 3 prefix + bucket/8 audio + 160 suffix + 256 new tokens
    attn_rows = []
    for S, M in ((1, 675), (1, 803), (4, 1024)):
        q, k, v = cache(S, M, torch.bfloat16)
        L = M - 1
        lens = torch.full((S,), L, dtype=torch.int32, device="cuda")
        kq = k[:, : L + 1].transpose(1, 2).contiguous()  # [S, nkv, L+1, hd]
        vq = v[:, : L + 1].transpose(1, 2).contiguous()
        qq = q[:, :, None, :]  # [S, nh, 1, hd]
        ms = timer.ms(lambda: decode_attention_cuda(q, k, v, lens))
        plain_ms = timer.ms(lambda: decode_attention_plain(q, k, v, lens))
        lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(qq, kq, vq, enable_gqa=True))
        esize = 2
        n_bytes = S * (nh * hd * esize + 2 * (L + 1) * nkv * hd * esize + nh * hd * 4 + 4)
        flops = S * 4 * nh * hd * (L + 1)
        b_ms, b_by = bound_ms(n_bytes, flops)
        chunk, splits = split_shape(S, M, nkv, n_sms)
        design = (f"split-KV: {splits} splits of {chunk} positions x {nkv} KV heads x {S} "
                  f"slots, 16-byte loads, deterministic merge kernel")
        log(f"decode_attention S={S} M={M} lens={L} bf16 ({design}): kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        attn_rows.append(dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              library_ms=lib_ms, design=design))

    # ---- log-mel: correctness at every bucket, ragged lengths, both tiles ----
    cfg = MelConfig()
    basis, fb = device_tables(cfg, torch.device("cuda"))
    mel_err = 0.0

    def mel_tile(padded, nf, tile):
        """The kernel with `tile` frames per block (the entry picks one)."""
        out, err = tmel._launch(padded, basis, fb, nf, cfg.hop_length, tile)
        check(err == 0, f"log_mel {tile}-frame tiles: cudaError {err}")
        return out

    signals = [(f"bucket {bucket}", bucket,
                speech((int(bucket * 0.8) * cfg.hop_length + 97 + 13 * i) / SR, seed=10 + i))
               for i, bucket in enumerate((128, 256, 512, 1024, 2048, 3072))]
    # 6 s near silence, then 6 s of speech
    signals.append(("quiet then loud", 2048, np.concatenate([silence(6.0, 8), speech(6.0, 9)])))
    for case, bucket, audio in signals:
        x = torch.from_numpy(audio).cuda()
        padded, nf = reflect_pad(x, cfg)
        raw_plain = log_mel_frames_plain(padded, basis, fb, nf, cfg.hop_length)
        # the same plain version in float64: how far float32 itself is off
        raw64 = log_mel_frames_plain(padded.double(), basis.double(), fb.double(), nf,
                                     cfg.hop_length).float()
        want = normalize_log_mel(raw_plain, cfg, bucket)
        entry = log_mel_frames_cuda(padded, basis, fb, nf, cfg.hop_length)
        for tile in FRAMES_PER_BLOCK:
            raw = mel_tile(padded, nf, tile)
            check(torch.equal(raw, entry) or tile != frames_per_block(nf, n_sms),
                  f"log_mel {case}: the entry differs from its own tile")
            got = normalize_log_mel(raw, cfg, bucket)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            raw_err = (raw - raw_plain).abs().max().item()
            check(got.shape == (bucket, cfg.n_mels), f"log_mel shape {tuple(got.shape)}")
            check(np.isfinite(err) and err <= MEL_TOL,
                  f"log_mel {case} tile {tile}: max err {err} > {MEL_TOL}")
            mel_err = max(mel_err, err)
            err64 = (raw - raw64).abs().max().item()
            plain_err64 = (raw_plain - raw64).abs().max().item()
            log(f"log_mel {case} ({nf} frames, {tile}-frame tiles): max abs err {err:.3g} <= "
                f"{MEL_TOL} (raw log10 {raw_err:.3g}; against float64 {err64:.3g}, float32 "
                f"plain against float64 {plain_err64:.3g})")

    # ---- log-mel: time at the ~12 s and ~30 s requests' shapes, both tiles ----
    mel_rows = []
    for sec in (12.0, 30.72):
        x = torch.from_numpy(speech(sec, seed=3)).cuda()
        padded, nf = reflect_pad(x, cfg)
        window = torch.hann_window(cfg.n_fft, periodic=True, device="cuda")

        def library():
            spec = torch.stft(x, cfg.n_fft, cfg.hop_length, window=window, center=True,
                              pad_mode="reflect", return_complex=True)
            power = spec[:, :nf].abs() ** 2
            return torch.log10(torch.clamp(power.T @ fb, min=1e-10))

        tile_ms = {tile: timer.ms(lambda t=tile: mel_tile(padded, nf, t))
                   for tile in FRAMES_PER_BLOCK}
        tile = frames_per_block(nf, n_sms)
        ms = tile_ms[tile]
        plain_ms = timer.ms(lambda: log_mel_frames_plain(padded, basis, fb, nf, cfg.hop_length))
        lib_ms = timer.ms(library)
        n_bins = cfg.n_freq_bins
        n_bytes = 4 * (padded.numel() + basis.numel() + fb.numel() + nf * cfg.n_mels)
        flops = nf * (2 * cfg.n_fft * 2 * n_bins + 3 * n_bins + 2 * n_bins * cfg.n_mels)
        # the least of one float32 pass on the CUDA cores and three TF32
        # passes (3xTF32) on the tensor cores
        f32_ms, f32_by = bound_ms(n_bytes, flops)
        tf32_ms, tf32_by = bound_ms(n_bytes, 3 * flops, TF32_FLOPS_PER_S)
        b_ms, b_by = min((f32_ms, f32_by), (tf32_ms, tf32_by))
        log(f"log_mel {nf} frames: kernel {ms:.4f} ms ({tile}-frame tiles; "
            + ", ".join(f"{t}: {v:.4f}" for t, v in tile_ms.items())
            + f"), plain {plain_ms:.4f} ms, stft+matmul {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
            f"({b_by}; float32 CUDA cores {f32_ms:.5f}, 3xTF32 tensor cores {tf32_ms:.5f})")
        mel_rows.append(dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            design=(f"3xTF32 DFT on the tensor cores (mma.sync m16n8k8; big/small TF32 "
                    f"split, round to nearest away, in registers; each k-step's sums from "
                    f"zero, added in float32 on the CUDA cores), {tile}-frame blocks "
                    f"across all 402 columns, frames (im2col) and a 3-stage ring of 16-row "
                    f"basis slices in shared memory by bulk copies (cp.async.bulk on "
                    f"mbarriers), banded mel projection"),
            tile_ms={str(t): v for t, v in tile_ms.items()}, bound_f32_ms=f32_ms,
            bound_3xtf32_ms=tf32_ms))
    return attn_err, attn_rows[0], mel_err, mel_rows[0]


def verify_lens(torch, S: int, gen):
    """Verify phase lens at M = VERIFY_M: 674 at S 1; mixed at S 4; at S 33
    random with slots whose lens + VERIFY_W1 passes M (their writes past the
    end: the clamp), one at M - 1 and one at M."""
    M = VERIFY_M
    if S == 1:
        return torch.tensor([674], dtype=torch.int32, device="cuda")
    if S == 4:
        return torch.tensor([0, 300, 795, M - 1], dtype=torch.int32, device="cuda")
    lens = torch.randint(0, M, (S,), generator=gen, device="cuda")
    lens[:6] = torch.tensor([0, M - 1, M - 3, M - 9, M - 5, M])
    return lens.to(torch.int32)


def verify_kernel_phase(torch, timer) -> dict:
    """verify_attention (csrc/decode_attention.cu's verify entries) against
    verify_attention_plain at nano's heads and M = VERIFY_M, S 1, 4 and 33
    (verify_lens), W1 = VERIFY_W1 and 1, float32 and bf16, within ATTN_TOL;
    each bf16 W1 = VERIFY_W1 launch on the tensor-core kernel
    (verify_attention_mma counts it), no other; at W1 = 1 equal, bit for
    bit, to decode_attention on the same inputs. The float32 W1 =
    VERIFY_W1 cases are timed alone (the CUDA-core kernel, tiny's on the
    card). Then, in bf16, each case's time (cold L2, median of 30) beside the plain
    version's, SDPA's with the equivalent boolean mask (a yardstick the port
    never calls) and its bound: the bytes (q, each slot's K/V rows up to
    its last query's position, out) at 3.35 TB/s against the operations
    (4 * nh * hd per query and position it sees) at 989 TFLOP/s bf16 on the
    tensor cores, which run the two products (three bf16 parts of P: the
    bound counts the work once); the float32 CUDA-core figure (67
    TFLOP/s) printed beside. -> {"max_abs_err", "shapes": {case:
    numbers}, "main": the S 1, W1 9 case's numbers (a single drafted
    final: the rows = 1 program)}."""
    import torch.nn.functional as F

    from sonicscribe_tpu_torch.models.config import nano
    from sonicscribe_tpu_torch.ops import _build
    from sonicscribe_tpu_torch.ops.decode_attention import (
        decode_attention_cuda,
        split_shape,
        verify_attention_cuda,
        verify_attention_plain,
        verify_uses_mma,
    )

    dec = nano().decoder
    nh, nkv, hd, M = dec.n_heads, dec.n_kv_heads, dec.head_dim, VERIFY_M
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 13)
    n_sms = _build.n_sms(torch.device("cuda"))
    err_max, shapes = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for S in (1, 4, 33):
            lens = verify_lens(torch, S, gen)
            k = torch.randn((2, S, M, nkv, hd), generator=gen, device="cuda").to(dtype)[1]
            v = torch.randn((2, S, M, nkv, hd), generator=gen, device="cuda").to(dtype)[1]
            for W1 in (VERIFY_W1, 1):
                q = torch.randn((S, W1, nh, hd), generator=gen, device="cuda").to(dtype)
                case = f"S={S} W1={W1} {str(dtype)[6:]}"
                mma0 = _build.launch_counts["verify_attention_mma"]
                got = verify_attention_cuda(q, k, v, lens)
                mma = _build.launch_counts["verify_attention_mma"] - mma0
                check(mma == (dtype == torch.bfloat16 and W1 > 1) == verify_uses_mma(q),
                      f"verify_attention {case}: {mma} tensor-core launches")
                err = (got - verify_attention_plain(q, k, v, lens)).abs().max().item()
                check(np.isfinite(err) and err <= ATTN_TOL,
                      f"verify_attention {case} lens {lens.tolist()}: max err {err} > {ATTN_TOL}")
                err_max = max(err_max, err)
                if W1 == 1:
                    check(torch.equal(got[:, 0], decode_attention_cuda(q[:, 0], k, v, lens)),
                          f"verify_attention {case}: differs from decode_attention")
                if dtype != torch.bfloat16:
                    if W1 > 1:
                        ms = timer.ms(lambda: verify_attention_cuda(q, k, v, lens))
                        shapes[f"S{S}_W{W1}_f32"] = dict(ms=ms, err=err)
                        log(f"verify_attention {case} M={M}: kernel {ms:.4f} ms (CUDA cores), "
                            f"max abs err {err:.3g}")
                    continue
                qpos = lens.long()[:, None] + torch.arange(W1, device="cuda")[None, :]
                mask = (torch.arange(M, device="cuda")[None, None, :] <= qpos[:, :, None])[:, None]
                qq, kq, vq = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                ms = timer.ms(lambda: verify_attention_cuda(q, k, v, lens))
                plain_ms = timer.ms(lambda: verify_attention_plain(q, k, v, lens))
                lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
                    qq, kq, vq, attn_mask=mask, enable_gqa=True))
                seen = torch.clamp(qpos, max=M - 1) + 1  # [S, W1] positions each query sees
                n_bytes = (S * W1 * nh * hd * 2 + float(seen[:, -1].sum()) * 2 * nkv * hd * 2
                           + S * W1 * nh * hd * 4 + S * 4)
                flops = 4 * nh * hd * float(seen.sum())
                b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
                f32_ms, f32_by = bound_ms(n_bytes, flops)
                chunk, splits = split_shape(S, M, nkv, n_sms)
                rows = W1 * (nh // nkv)
                design = (f"{splits} splits of {chunk} positions x {nkv} KV heads x {S} slots, "
                          + (f"the {rows} query rows of a KV head as {-(-rows // 16)} m16 tiles "
                             f"on the bf16 tensor cores (mma.sync m16n8k16; P in three bf16 "
                             f"parts) over a 3-stage ring of 32-position K/V tiles"
                             if W1 > 1 else "the decode kernel"))
                log(f"verify_attention {case} M={M} lens {'mixed' if S > 1 else lens.tolist()} "
                    f"({design}): max abs err {err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                    f"ms, SDPA (masked) "
                    f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}; float32 CUDA cores "
                    f"{f32_ms:.5f} ms, {f32_by})")
                shapes[f"S{S}_W{W1}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                            bound_ms=b_ms, bound_by=b_by, bound_f32_ms=f32_ms,
                                            err=err, design=design)
    log(f"verify_attention: max abs err {err_max:.3g} <= {ATTN_TOL} (f32 and bf16, S 1, 4, 33, "
        f"W1 {VERIFY_W1} and 1, lens past M - W1 at S 33); bf16 W1 {VERIFY_W1} on the tensor "
        f"cores; at W1 = 1 equal to decode_attention")
    return dict(max_abs_err=err_max, shapes=shapes, main=shapes[f"S1_W{VERIFY_W1}"])


def int8_kernel_phase(torch, timer):
    """The three int8 entries against their plain versions at nano's
    shapes, then their times; -> ({entry: max abs err}, {entry: row})."""
    from sonicscribe_tpu_torch.engine.transcriber import MAX_SUFFIX_TOKENS
    from sonicscribe_tpu_torch.models.config import nano
    from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer, build_prompt
    from sonicscribe_tpu_torch.ops import _build
    from sonicscribe_tpu_torch.ops import int8_matmul as im
    from sonicscribe_tpu_torch.ops.quant import dequantize_tensor, quantize_tensor

    cfg = nano()
    dec, enc = cfg.decoder, cfg.encoder
    shapes = {  # (K, N)
        "qkv": (dec.d_model, (dec.n_heads + 2 * dec.n_kv_heads) * dec.head_dim),
        "o": (dec.n_heads * dec.head_dim, dec.d_model),
        "gate_up": (dec.d_model, 2 * dec.ffn_hidden),
        "down": (dec.ffn_hidden, dec.d_model),
        "enc_fc1": (enc.d_model, enc.ffn_mult * enc.d_model),
        "enc_fc2": (enc.ffn_mult * enc.d_model, enc.d_model),
    }
    # prompt rows of the ~12 s request (bucket 2048) and encoder rows at bucket 3072
    prefix = len(build_prompt(ByteTokenizer(cfg), cfg).prefix_ids)
    prefill_rows = prefix + 2048 // cfg.frames_per_audio_token + MAX_SUFFIX_TOKENS
    encoder_rows = 3072 // 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    # two-layer stacks: layer 1 is read by offset from the whole stack
    stacks = {p: quantize_tensor(torch.randn((2, K, N), generator=gen, device="cuda") * 0.02)
              for p, (K, N) in shapes.items()}

    def x_of(B, K, dtype):
        return torch.randn((B, K), generator=gen, device="cuda").to(dtype)

    errs = {"int8_matmul": 0.0, "int8_matmul_stacked": 0.0, "int8_matmul_w8a8": 0.0}

    def check_w8a16(name, got, want, case):
        errs[name] = max(errs[name], check_w16(torch, name, got, want, case))

    def check_flat(B, p, dtype):
        """The flat and the stacked entry at B rows of projection p: the mma
        counter must rise exactly for bf16 x with B > 8."""
        q, sc = stacks[p]["q"], stacks[p]["scale"]
        x = x_of(B, shapes[p][0], dtype)
        before = _build.launch_counts["int8_matmul_mma"]
        got = im.int8_matmul_cuda(x, q[1], sc[1])
        got_st = im.int8_matmul_stacked_cuda(x, q, sc, 1)
        mma = _build.launch_counts["int8_matmul_mma"] - before
        check(mma == 2 * int(dtype == torch.bfloat16 and B > 8),
              f"int8_matmul {p} B={B} {dtype}: int8_matmul_mma rose by {mma}")
        want = im.int8_matmul_plain(x, q[1], sc[1])
        check_w8a16("int8_matmul", got, want, f"{p} B={B} {dtype}")
        check_w8a16("int8_matmul_stacked", got_st, want, f"{p} B={B} {dtype}")

    def recipe(x, q, sc):
        """The plain W8A8 (the JAX recipe) on CPU copies, layer 1, back on the card."""
        return im.int8_matmul_w8a8_plain(x.cpu(), q.cpu(), sc.cpu(), 1).cuda()

    def w8a8_design(design, x, q, sc, **kw):
        """One W8A8 design forced on layer 1 (the entry picks by B)."""
        launch = im._launch_w8a8_mma if design == "mma" else im._launch_w8a8_cluster
        out, err = launch(x, q, sc, 1, **kw)
        check(err == 0, f"W8A8 {design} design B={x.shape[0]}: cudaError {err}")
        return out

    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 2, 4, 5, 8):
            for p in ("qkv", "o", "gate_up", "down"):
                K, _ = shapes[p]
                q, sc = stacks[p]["q"], stacks[p]["scale"]
                x = x_of(B, K, dtype)
                case = f"{p} B={B} {dtype}"
                check_w8a16("int8_matmul", im.int8_matmul_cuda(x, q[1], sc[1]),
                            im.int8_matmul_plain(x, q[1], sc[1]), case)
                got = im.int8_matmul_stacked_cuda(x, q, sc, 1)
                check_w8a16("int8_matmul_stacked", got, im.int8_matmul_stacked_plain(x, q, sc, 1),
                            case)
                check(torch.equal(got, im.int8_matmul_stacked_cuda(x, q, sc, 1)),
                      f"int8_matmul_stacked {case}: two runs differ")
    # W8A8 at decode rows and either side of its design threshold: the
    # entry and both designs forced equal the recipe, two runs equal bits,
    # the mma counter rising exactly from W8A8_MMA_MIN_ROWS rows
    T = im.W8A8_MMA_MIN_ROWS
    w8a8_rows = sorted({1, 2, 4, 5, 8, T - 1, T})
    for dtype in (torch.float32, torch.bfloat16):
        for B in w8a8_rows:
            for p in ("qkv", "o", "gate_up", "down"):
                K, N = shapes[p]
                q, sc = stacks[p]["q"], stacks[p]["scale"]
                x = x_of(B, K, dtype)
                case = f"{p} B={B} {dtype}"
                before = _build.launch_counts["int8_matmul_w8a8_mma"]
                got = im.int8_matmul_w8a8_cuda(x, q, sc, 1)
                mma = _build.launch_counts["int8_matmul_w8a8_mma"] - before
                check(mma == int(B >= T), f"int8_matmul_w8a8 {case}: the mma counter rose by {mma}")
                want = recipe(x, q, sc)
                check(torch.equal(got, want), f"int8_matmul_w8a8 {case}: max err "
                      f"{(got.float() - want.float()).abs().max().item()}, want equal")
                check(torch.equal(got, im.int8_matmul_w8a8_cuda(x, q, sc, 1)),
                      f"int8_matmul_w8a8 {case}: two runs differ")
                for design in ("cluster", "mma"):
                    check(torch.equal(w8a8_design(design, x, q, sc), want),
                          f"int8_matmul_w8a8 {case}, {design} design: differs from the recipe")
    # crafted rows: all zeros (the 1e-8 floor), x / sx on .5 (half to even),
    # the largest magnitude negative, both ends at +-127
    K = shapes["qkv"][0]
    q, sc = stacks["qkv"]["q"], stacks["qkv"]["scale"]
    x = x_of(8, K, torch.float32)
    x[0] = 0.0
    x[1] = 0.0
    x[1, :8] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5], device="cuda")
    x[2, 5] = -3.0 * x[2].abs().max()
    x[3] = torch.linspace(-1.0, 1.0, K, device="cuda") * 127.0
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (4, 8):
            xd = x[:rows].to(dtype).contiguous()
            want = recipe(xd, q, sc)
            for design, got in (("entry", im.int8_matmul_w8a8_cuda(xd, q, sc, 1)),
                                ("cluster", w8a8_design("cluster", xd, q, sc)),
                                ("mma", w8a8_design("mma", xd, q, sc))):
                check(torch.equal(got, want) and not bool(got[0].any()),
                      f"int8_matmul_w8a8 crafted rows, B={rows} {dtype}, {design}: differ from "
                      f"the recipe")
        for B, p in ((prefill_rows, "qkv"), (prefill_rows, "down"),
                     (encoder_rows, "enc_fc1"), (encoder_rows, "enc_fc2")):
            check_flat(B, p, dtype)
    for B in (8, 9, 17, 227):  # either side of the design switch, and a ragged row tile
        for p in ("qkv", "o", "gate_up", "down"):
            check_flat(B, p, torch.bfloat16)
    torch.cuda.synchronize()
    log(f"int8 kernels vs plain: max abs err W8A16 flat {errs['int8_matmul']:.3g}, stacked "
        f"{errs['int8_matmul_stacked']:.3g} (tolerance {INT8_F32_TOL} x max|want|, + one "
        f"bf16 ulp in bf16; two stacked runs equal bits); W8A8 equal to the recipe on CPU "
        f"copies, the entry and both designs forced, two runs equal (B "
        f"{','.join(map(str, w8a8_rows))} at qkv/o/gate_up/down and crafted rows; the mma "
        f"design ran exactly for B >= {T}); W8A16 flat also "
        f"B={prefill_rows} qkv/down, B={encoder_rows} enc fc1/fc2, f32 and bf16, and bf16 "
        f"B 8,9,17,227 at qkv/o/gate_up/down; the mma design ran exactly for bf16 B > 8)")

    # one stacked W8A16 call is one kernel; a W8A8 call runs only W8A8 kernels
    q, sc = stacks["qkv"]["q"], stacks["qkv"]["scale"]
    x = x_of(1, shapes["qkv"][0], torch.bfloat16)
    names = kernel_names(torch, lambda: im.int8_matmul_stacked_cuda(x, q, sc, 1))
    check(len(names) == 1, f"a stacked W8A16 call at B=1 ran {names}")
    log(f"profile of one stacked W8A16 call (qkv, B=1): one kernel, {names[0][:60]}")
    names = kernel_names(torch, lambda: im.int8_matmul_w8a8_cuda(x, q, sc, 1))
    check(len(names) == 1 and "w8a8" in names[0].lower(), f"a W8A8 call at B=1 ran {names}")
    log(f"profile of one W8A8 call (qkv, B=1): one kernel, {names[0][:70]}")
    for B in (T, 64):
        xb = x_of(B, shapes["qkv"][0], torch.bfloat16)
        names = kernel_names(torch, lambda: im.int8_matmul_w8a8_cuda(xb, q, sc, 1))
        check(names and all("w8a8" in n.lower() for n in names),
              f"a W8A8 call at B={B} ran other kernels: {names}")
        log(f"profile of one W8A8 call (qkv, B={B}): only W8A8 kernels ran: "
            f"{[n.split('(')[0][-40:] for n in names]}")

    # ---- times at the main path's shapes, bf16 ----
    def time_row(label, name, fn, plain, lib, B, K, N, peak, lib_label):
        ms, plain_ms = timer.ms(fn), timer.ms(plain)
        lib_ms = timer.ms(lib) if lib is not None else None
        b_ms, b_by = bound_ms(K * N + 4 * N + 2 * B * (K + N), 2 * B * K * N, peak)
        lib_txt = f"{lib_label} {lib_ms:.4f} ms" if lib_ms is not None else f"{lib_label} n/a"
        log(f"{name} {label} B={B} K={K} N={N} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, {lib_txt}, bound {b_ms:.5f} ms ({b_by})")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

    rows = {}
    stacked_times, w8a8_times = {}, {}
    n_sms = _build.n_sms(torch.device("cuda"))
    for p in ("qkv", "o", "gate_up", "down"):
        K, N = shapes[p]
        q, sc = stacks[p]["q"], stacks[p]["scale"]
        x = x_of(1, K, torch.bfloat16)
        w = dequantize_tensor({"q": q[1], "scale": sc[1]}, torch.bfloat16)
        r = time_row(p, "int8_matmul_stacked", lambda: im.int8_matmul_stacked_cuda(x, q, sc, 1),
                     lambda: im.int8_matmul_stacked_plain(x, q, sc, 1), lambda: torch.mm(x, w),
                     1, K, N, BF16_FLOPS_PER_S, "bf16 dense mm (2x the bytes)")
        shape = im.cluster_shape(1, K, N)
        log(f"  launch: {shape.grid} CTAs, clusters of {shape.cluster} along K, "
            f"{shape.k_per_cta} rows of q ({shape.k_per_cta * 128 // 1024} KB) per CTA")
        stacked_times[p] = dict(ms=r["ms"], library_ms=r["library_ms"], bound_ms=r["bound_ms"],
                                cluster=shape.cluster, k_per_cta=shape.k_per_cta)
        if p == "gate_up":
            rows["int8_matmul_stacked"] = dict(
                r, design="one launch per call at B <= 8: a cluster of CTAs along K per 128 "
                "columns, each CTA's K slice loaded as 16-byte pieces into registers, 8 rows "
                "per k-lane in flight (4 at 8 x rows), x staged once, sums added in rank 0's "
                "shared memory through distributed shared memory in rank order "
                "(deterministic)", times=stacked_times)
    # W8A8: B=1 at the four projections, gate_up also at 8, 37 and 64 rows;
    # torch._int_mm (s8 x s8 -> int32, cuBLASLt) on x quantised beforehand
    # is the yardstick where it runs (B > 16), below that bf16 torch.mm on
    # the dequantised weight (as for the W8A16 rows)
    for B, p in ((1, "qkv"), (1, "o"), (1, "gate_up"), (1, "down"), (8, "gate_up"),
                 (37, "gate_up"), (64, "gate_up")):
        K, N = shapes[p]
        q, sc = stacks[p]["q"], stacks[p]["scale"]
        x = x_of(B, K, torch.bfloat16)
        xq = im.quantize_activations(x)[0]
        q_cm = q[1].t().contiguous().t()  # column-major s8, as cuBLASLt takes it
        w = dequantize_tensor({"q": q[1], "scale": sc[1]}, torch.bfloat16)
        r = time_row(p, "int8_matmul_w8a8", lambda: im.int8_matmul_w8a8_cuda(x, q, sc, 1),
                     lambda: im.int8_matmul_w8a8_plain(x, q, sc, 1),
                     (lambda: torch._int_mm(xq, q_cm)) if B > 16 else (lambda: torch.mm(x, w)),
                     B, K, N, INT8_OPS_PER_S,
                     "torch._int_mm (x quantised beforehand)" if B > 16
                     else "bf16 dense mm on the dequantised weight (2x the bytes)")
        if im.w8a8_uses_mma(B, N):
            splits, kps = im.s8_mma_shape(B, K, N, n_sms, im.W8A8_MMA_MAX_K_PER_SPLIT)
            launch = dict(design="mma", splits=splits, k_per_split=kps)
        else:
            shape = im.w8a8_cluster_shape(B, K, N)
            launch = dict(design="cluster", cluster=shape.cluster, k_per_cta=shape.k_per_cta)
        log(f"  launch: {launch}")
        w8a8_times[f"{p} B={B}"] = dict(ms=r["ms"], library_ms=r["library_ms"],
                                        bound_ms=r["bound_ms"], **launch)
        if (B, p) == (1, "gate_up"):
            rows["int8_matmul_w8a8"] = dict(r, design=W8A8_DESIGN, times=w8a8_times)

    # the design space of the cluster split-K kernel: every cluster size
    # whose slices fit, on the same inputs
    floor_t = torch.zeros(1, device="cuda")
    floor_ms = timer.ms(lambda: floor_t.add_(1.0))
    log(f"timer floor: one 1-element add kernel {floor_ms:.4f} ms")
    space = {}
    for B, p in ((B, p) for B in (1, 2, 4, 8) for p in ("qkv", "o", "gate_up", "down")):
        K, N = shapes[p]
        q, sc = stacks[p]["q"], stacks[p]["scale"]
        x = x_of(B, K, torch.bfloat16)
        want = im.int8_matmul_stacked_plain(x, q, sc, 1)
        cells = []
        for cluster in (2, 4, 8, 16):
            shape = im.cluster_shape(B, K, N, cluster=cluster)
            if shape.k_per_cta > 1024 or im.cluster_smem(1, shape.rows, cluster,
                                                          shape.k_per_cta) > im.MAX_SMEM:
                continue

            def run(cluster=cluster):
                out, err = im._launch_streaming(x, q, sc, 1, cluster=cluster)
                check(err == 0, f"W8A16 {p} cluster {cluster}: cudaError {err}")
                return out
            got = run()
            check_w16(torch, "int8_matmul_stacked", got, want, f"{p} cluster {cluster}")
            check(torch.equal(got, run()), f"W8A16 {p} cluster {cluster}: two runs differ")
            t = timer.ms(run)
            cells.append(f"{cluster}: {t:.4f}")
            space[f"{p} B={B} cluster={cluster}"] = t
        log(f"int8_matmul_stacked {p} B={B}, ms by cluster size (dispatched "
            f"{im.cluster_shape(B, K, N).cluster}): " + ", ".join(cells))
    # the cluster kernel's fixed cost: 16 rows of q per CTA at o's N (4 KB
    # of weight per cluster rank), by cluster size
    cells = []
    for cluster in (1, 2, 8, 16):
        qt = quantize_tensor(torch.randn((1, 16 * cluster, 2048), generator=gen, device="cuda"))
        x = x_of(1, 16 * cluster, torch.bfloat16)
        t = timer.ms(lambda: im._launch_streaming(x, qt["q"], qt["scale"], 0, cluster=cluster))
        cells.append(f"cluster {cluster} {t:.4f}")
        space[f"fixed cost, 16 rows per CTA, N=2048, cluster={cluster}"] = t
    log("int8_matmul_stacked fixed cost (16 rows of q per CTA, N=2048, B=1): " + ", ".join(cells))
    rows["int8_matmul_stacked"]["design_space"] = space
    rows["int8_matmul_stacked"]["timer_floor_ms"] = floor_ms

    # W8A8's design space: the cluster sizes that fit its integer policy at
    # B 1, 2 and 4, and the threshold A/B of the cluster design against the
    # s8 tensor cores
    space, threshold = {}, {}
    for B, p in ((B, p) for B in (1, 2, 4) for p in ("qkv", "o", "gate_up", "down")):
        K, N = shapes[p]
        q, sc = stacks[p]["q"], stacks[p]["scale"]
        x = x_of(B, K, torch.bfloat16)
        want = recipe(x, q, sc)
        cells = []
        for cluster in (2, 4, 8, 16):
            shape = im.w8a8_cluster_shape(B, K, N, cluster)
            if shape.k_per_cta > 1024 or im.cluster_smem(1, shape.rows, cluster, shape.k_per_cta,
                                                          1) > im.MAX_SMEM:
                continue
            got = w8a8_design("cluster", x, q, sc, cluster=cluster)
            check(torch.equal(got, want), f"W8A8 {p} B={B} cluster {cluster}: differs")
            t = timer.ms(lambda c=cluster: w8a8_design("cluster", x, q, sc, cluster=c))
            cells.append(f"{cluster}: {t:.4f}")
            space[f"{p} B={B} cluster={cluster}"] = t
        log(f"int8_matmul_w8a8 {p} B={B}, ms by cluster size (dispatched "
            f"{im.w8a8_cluster_shape(B, K, N).cluster}): " + ", ".join(cells))
    for p in ("qkv", "o", "gate_up", "down"):
        K, N = shapes[p]
        q, sc = stacks[p]["q"], stacks[p]["scale"]
        for B in (1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 32, 64, 128, 256):
            x = x_of(B, K, torch.bfloat16)
            cc = w8a8_design("cluster", x, q, sc)
            check(torch.equal(cc, w8a8_design("mma", x, q, sc)),
                  f"W8A8 {p} B={B}: the two designs differ")
            cc_ms = timer.ms(lambda: w8a8_design("cluster", x, q, sc))
            mma_ms = timer.ms(lambda: w8a8_design("mma", x, q, sc))
            threshold[f"{p} B={B}"] = dict(cluster_splitk_ms=cc_ms, mma_ms=mma_ms)
            log(f"int8_matmul_w8a8 {p} B={B} bf16: cluster split-K design {cc_ms:.4f} ms, "
                f"tensor-core design {mma_ms:.4f} ms (dispatched: "
                f"{'mma' if im.w8a8_uses_mma(B, N) else 'cluster split-K'})")
    rows["int8_matmul_w8a8"].update(design_space=space, threshold=threshold)

    def cuda_core_w8a16(x, q, sc):
        """The cluster split-K W8A16 design on the same inputs, launched
        directly (the flat entry sends bf16 B > 8 to the tensor cores)."""
        out, err = im._launch_streaming(x, q[None], sc[None], 0)
        check(err == 0, f"cluster split-K int8_matmul_w8a16: cudaError {err}")
        return out

    flat_rows = {}
    for B, p in ((prefill_rows, "qkv"), (prefill_rows, "down"),
                 (encoder_rows, "enc_fc1"), (encoder_rows, "enc_fc2")):
        K, N = shapes[p]
        q, sc = stacks[p]["q"][1], stacks[p]["scale"][1]
        x = x_of(B, K, torch.bfloat16)
        w = dequantize_tensor({"q": q, "scale": sc}, torch.bfloat16)
        r = time_row(p, "int8_matmul", lambda: im.int8_matmul_cuda(x, q, sc),
                     lambda: im.int8_matmul_plain(x, q, sc), lambda: torch.mm(x, w),
                     B, K, N, BF16_FLOPS_PER_S, "bf16 dense mm (2x the weight bytes)")
        check_w8a16("int8_matmul", cuda_core_w8a16(x, q, sc), im.int8_matmul_plain(x, q, sc),
                    f"{p} B={B} CUDA-core design")
        cc_ms = timer.ms(lambda: cuda_core_w8a16(x, q, sc))
        log(f"  the cluster split-K design on the same inputs: {cc_ms:.4f} ms "
            f"(mma {cc_ms / r['ms']:.1f}x faster; {2 * B * K * N / r['ms'] / 1e9:.1f} TFLOP/s)")
        flat_rows[f"{p} B={B}"] = dict(ms=r["ms"], cuda_core_ms=cc_ms, library_ms=r["library_ms"])
        if (B, p) == (prefill_rows, "qkv"):
            rows["int8_matmul"] = dict(
                r, design="mma.sync m16n8k16 bf16 on the tensor cores for bf16 x with B > 8 "
                "(64 x 128 tiles, K steps of 128, 3-stage cp.async, int8 read by "
                "ldmatrix.trans and dequantised exactly in registers); the cluster split-K "
                "design for B <= 8 and float32 x", flat_shapes=flat_rows)
    return errs, rows


# int4 entry -> (line of its TPU kernel in ops/int4_pallas.py, the path its
# launches are counted on: no entry point of either package serves the
# flat forms, and the JAX package reaches the stacked ones only through
# its int4 sweep)
INT4_ENTRIES = {
    "int4_matmul": (102, "kernel phase (timed runs)"),
    "int4_matmul_stacked": (165, "tools/bench_int4_matmul (int4_w4a16, one eager step)"),
    "int4_matmul_w4a8": (241, "kernel phase (timed runs)"),
    "int4_matmul_w4a8_stacked": (313, "tools/bench_int4_matmul (int4_w4a8, one eager step)"),
}


W8A8_DESIGN = (
    "x quantised per row in CUDA (IEEE sx, rint half to even; no PyTorch kernel); B < "
    "W8A8_MMA_MIN_ROWS: one launch of the cluster split-K kernel with the integer policy "
    "(weight loads issued first, each CTA's rows' max|x| over the whole K, x's slice "
    "quantised into shared memory as words of 4 k, 4 rows of q per k-lane regrouped by "
    "__byte_perm, one __dp4a per column and row, int32 slots added in rank 0 in rank "
    "order); from W8A8_MMA_MIN_ROWS rows: a quantise kernel (a block per row, xq in the "
    "fragments' k order), then s8 x s8 tensor cores (mma.sync m16n8k32, 64 x 128 tiles of "
    "8 warps, q read as stored by ldmatrix.trans + __byte_perm, 4-stage cp.async ring, "
    "split-K to about one block per SM)")

W4A16_DESIGN = (
    "bf16 B >= W4A16_MMA_MIN_ROWS: bf16 tensor cores (mma.sync m16n8k16, 64 x 128 tiles of "
    "8 warps, 4-stage cp.async ring of packed rows as stored and both halves of x, "
    "ldmatrix.trans + __byte_perm into 0x4300 | (code + 8) and __hsub2 136: exact bf16 "
    "codes, split-K to about one block per SM); decode rows and float32 x: the cluster "
    "split-K design of the stacked W8A16 kernel (one launch)")

W4A8_DESIGN = (
    "x quantised per row in CUDA (IEEE sx, rint half to even; no PyTorch kernel); "
    "B >= 5: a quantise kernel (a block per row, xq in the fragments' k order), then "
    "s8 x u8 tensor cores (mma.sync m16n8k32, 64 x 128 tiles of 8 warps, packed read "
    "as stored by ldmatrix.trans + __byte_perm + nibble mask/xor, code + 8 with "
    "8 * sum(xq) taken off, 4-stage cp.async ring, split-K to about one block per SM); "
    "B <= 4: CUDA-core streaming, fused (rows' max|x| per block, __vsub4 + 2 __dp4a)")


def int4_kernel_phase(torch, timer):
    """The four int4 entries against their plain versions at nano's decode
    shapes (flat, and layer 1 of a two-layer stack), then their times. The
    W4A8 entries quantise x in the kernel with the JAX recipe (an IEEE
    division for sx); PyTorch's CUDA division by a Python scalar multiplies
    by its reciprocal, so their plain version runs on CPU copies of the
    inputs. The launch counters are set to 0 just before the timed runs
    and read just after: no entry point of either package serves the flat
    forms, so their timed runs are their path (INT4_ENTRIES). -> ({entry:
    max abs err}, {entry: row}, {entry: launches in the timed runs})."""
    from sonicscribe_tpu_torch.models.config import nano
    from sonicscribe_tpu_torch.ops import _build
    from sonicscribe_tpu_torch.ops import int4_matmul as i4
    from sonicscribe_tpu_torch.ops.int8_matmul import quantize_activations
    from sonicscribe_tpu_torch.tools.bench_int8_matmul import layer_shapes

    # (K, N) of qkv, o, gate_up and down; down's K/2 = 2752 leaves a ragged
    # last chunk of 128 packed rows
    shapes = {p.removesuffix("_w"): (K, N) for p, (_, K, N) in layer_shapes(nano()).items()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    stacks = {}
    for p, (K, N) in shapes.items():  # codes in [-8, 7]: -8 is a valid nibble
        codes = torch.randint(-8, 8, (2, K, N), generator=gen, device="cuda", dtype=torch.int8)
        stacks[p] = dict(codes=codes, packed=i4.pack_int4(codes),
                         scale=0.02 + 0.01 * torch.rand((2, 1, N), generator=gen, device="cuda"))
        stacks[p]["cpu"] = {k: v.cpu() for k, v in stacks[p].items()}

    def x_of(B, K, dtype):
        return torch.randn((B, K), generator=gen, device="cuda").to(dtype)

    def recipe(x, p):
        """The plain W4A8 on CPU copies (layer 1), back on the card."""
        c = stacks[p]["cpu"]
        return i4.int4_matmul_w4a8_plain(x.cpu(), c["packed"][1], c["scale"][1]).cuda()

    errs = dict.fromkeys(INT4_ENTRIES, 0.0)
    sx_rows = sx_old = sx_new = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 2, 4, 5, 8, 9, 16, 17, 37, 64, 227):
            for p, (K, _) in shapes.items():
                pk, sc = stacks[p]["packed"], stacks[p]["scale"]
                x = x_of(B, K, dtype)
                case = f"{p} B={B} {dtype}"
                before = _build.launch_counts["int4_matmul_w4a16_mma"]
                for name, got, want in (
                    ("int4_matmul", i4.int4_matmul_cuda(x, pk[1], sc[1]),
                     i4.int4_matmul_plain(x, pk[1], sc[1])),
                    ("int4_matmul_stacked", i4.int4_matmul_stacked_cuda(x, pk, sc, 1),
                     i4.int4_matmul_stacked_plain(x, pk, sc, 1)),
                ):
                    errs[name] = max(errs[name], check_w16(torch, name, got, want, case))
                mma = _build.launch_counts["int4_matmul_w4a16_mma"] - before
                check(mma == 2 * int(i4.w4a16_uses_mma(B, dtype)),
                      f"W4A16 {case}: int4_matmul_w4a16_mma rose by {mma}")
                before = _build.launch_counts["int4_matmul_w4a8_mma"]
                flat = i4.int4_matmul_w4a8_cuda(x, pk[1], sc[1])
                stacked = i4.int4_matmul_w4a8_stacked_cuda(x, pk, sc, 1)
                mma = _build.launch_counts["int4_matmul_w4a8_mma"] - before
                check(mma == 2 * int(i4.w4a8_uses_mma(B)),
                      f"W4A8 {case}: int4_matmul_w4a8_mma rose by {mma}")
                want = recipe(x, p)
                for name, got in (("int4_matmul_w4a8", flat),
                                  ("int4_matmul_w4a8_stacked", stacked)):
                    check(torch.equal(got, want), f"{name} {case}: max err "
                          f"{(got.float() - want.float()).abs().max().item()}, want equal")
                # how often the card's plain quantisation leaves the recipe:
                # the old `/ 127.0` (a reciprocal multiply on the card), and
                # quantize_activations now (div127: must be never)
                want_sx = quantize_activations(x.cpu())[1]
                old_sx = torch.clamp(x.float().abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
                sx_rows += B
                sx_old += int((old_sx.cpu() != want_sx).sum())
                sx_new += int((quantize_activations(x)[1].cpu() != want_sx).sum())
    # crafted rows: all zeros (the 1e-8 floor), x / sx on .5 (half to even),
    # the largest magnitude negative (-127), both ends at +-127
    K, N = shapes["qkv"]
    x = x_of(37, K, torch.float32)
    x[0] = 0.0
    x[1] = 0.0
    x[1, :8] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5], device="cuda")
    x[2, 5] = -3.0 * x[2].abs().max()
    x[3] = torch.linspace(-1.0, 1.0, K, device="cuda") * 127.0
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (4, 37):  # both designs
            xd = x[:rows].to(dtype).contiguous()
            got = i4.int4_matmul_w4a8_cuda(xd, stacks["qkv"]["packed"][1],
                                           stacks["qkv"]["scale"][1])
            check(torch.equal(got, recipe(xd, "qkv")) and not bool(got[0].any()),
                  f"int4_matmul_w4a8 crafted rows, B={rows} {dtype}: differ from the recipe")
    torch.cuda.synchronize()
    check(sx_new == 0, f"quantize_activations on the card left the recipe in {sx_new} rows")
    log(f"int4 kernels vs plain: max abs err W4A16 flat {errs['int4_matmul']:.3g}, stacked "
        f"{errs['int4_matmul_stacked']:.3g} (tolerance {INT8_F32_TOL} x max|want|, + one bf16 "
        f"ulp in bf16; the mma design ran exactly for bf16 B >= {i4.W4A16_MMA_MIN_ROWS}); W4A8 "
        f"flat and stacked equal to the recipe (crafted rows too; the mma design ran exactly "
        f"for B >= {i4.W4A8_MMA_MIN_ROWS}); B 1,2,4,5,8,9,16,17,37,64,227 at qkv/o/gate_up/"
        f"down; f32 and bf16; stacked: layer 1 of 2. sx on the card against the recipe on the "
        f"CPU: the old `/ 127.0` differed in {sx_old} of {sx_rows} rows, "
        f"quantize_activations (div127) in {sx_new}")

    # a W4A8 call launches only int4_matmul.cu's kernels
    pk, sc = stacks["gate_up"]["packed"], stacks["gate_up"]["scale"]
    xs = [x_of(B, shapes["gate_up"][0], torch.bfloat16) for B in (1, 64)]
    names = sorted(set(kernel_names(torch, lambda: [
        i4.int4_matmul_w4a8_stacked_cuda(x, pk, sc, 1) for x in xs])))
    check(names and all("w4a8" in n for n in names), f"W4A8 calls ran other kernels: {names}")
    log(f"profile of two W4A8 calls (B 1 and 64): only {len(names)} kernels of "
        f"int4_matmul.cu ran: {[n.split('(')[0][-40:] for n in names]}")

    # ---- below the design threshold: the tensor-core design on the same inputs ----
    def w4a8_mma(x, pk, sc):
        """The tensor-core W4A8 design on layer 1, launched directly (the
        entry takes it from W4A8_MMA_MIN_ROWS rows)."""
        out, err = i4._launch_mma(x, pk, sc, 1)
        check(err == 0, f"W4A8 tensor-core design B={x.shape[0]}: cudaError {err}")
        return out

    for p in ("gate_up", "down"):
        K, _ = shapes[p]
        pk, sc = stacks[p]["packed"], stacks[p]["scale"]
        for B in (1, 4):
            x = x_of(B, K, torch.bfloat16)
            check(torch.equal(w4a8_mma(x, pk, sc), i4.int4_matmul_w4a8_stacked_cuda(x, pk, sc, 1)),
                  f"W4A8 {p} B={B}: the two designs differ")
            cc_ms = timer.ms(lambda: i4.int4_matmul_w4a8_stacked_cuda(x, pk, sc, 1))
            mma_ms = timer.ms(lambda: w4a8_mma(x, pk, sc))
            log(f"int4_matmul_w4a8_stacked {p} B={B} bf16: CUDA-core design (dispatched) "
                f"{cc_ms:.4f} ms, tensor-core design {mma_ms:.4f} ms")

    # ---- W4A16: both designs on the same inputs either side of the threshold ----
    def w4a16_design(launch, x, pk, sc):
        out, err = launch(x, pk, sc, 1)
        check(err == 0, f"W4A16 {launch.__name__} B={x.shape[0]}: cudaError {err}")
        return out

    threshold = {}
    for p, Bs in (("gate_up", (1, 2, 3, 4, 5, 8, 9, 16, 37, 64)), ("qkv", (1, 2, 3, 4, 5, 8, 9)),
                  ("o", (1, 2, 3, 4, 5, 8, 9)), ("down", (1, 2, 3, 4, 5, 8, 9))):
        K, N = shapes[p]
        pk, sc = stacks[p]["packed"], stacks[p]["scale"]
        for B in Bs:
            x = x_of(B, K, torch.bfloat16)
            want = i4.int4_matmul_stacked_plain(x, pk, sc, 1)
            for launch in (i4._launch_w4a16_streaming, i4._launch_w4a16_mma):
                check_w16(torch, "int4_matmul_stacked", w4a16_design(launch, x, pk, sc), want,
                          f"{p} B={B} {launch.__name__}")
            cc_ms = timer.ms(lambda: w4a16_design(i4._launch_w4a16_streaming, x, pk, sc))
            mma_ms = timer.ms(lambda: w4a16_design(i4._launch_w4a16_mma, x, pk, sc))
            threshold[f"{p} B={B}"] = dict(cluster_splitk_ms=cc_ms, mma_ms=mma_ms)
            log(f"int4_matmul_stacked {p} B={B} bf16: cluster split-K design {cc_ms:.4f} ms, "
                f"tensor-core design {mma_ms:.4f} ms (dispatched: "
                f"{'mma' if i4.w4a16_uses_mma(B, torch.bfloat16) else 'cluster split-K'})")

    # the cluster split-K design at B=1: every cluster size
    space = {}
    for p, (K, N) in shapes.items():
        pk, sc = stacks[p]["packed"], stacks[p]["scale"]
        x = x_of(1, K, torch.bfloat16)
        want = i4.int4_matmul_stacked_plain(x, pk, sc, 1)
        cells = []
        for cluster in (2, 4, 8, 16):
            if i4.cluster_shape(1, K // 2, N, halves=2, cluster=cluster).k_per_cta > 1024:
                continue

            def run(cluster=cluster):
                return w4a16_design(lambda *a: i4._launch_w4a16_streaming(
                    *a, cluster=cluster), x, pk, sc)
            check_w16(torch, "int4_matmul_stacked", run(), want, f"{p} cluster {cluster}")
            t = timer.ms(run)
            cells.append(f"{cluster}: {t:.4f}")
            space[f"{p} B=1 cluster={cluster}"] = t
        shape = i4.cluster_shape(1, K // 2, N, halves=2)
        log(f"int4_matmul_stacked {p} B=1, ms by cluster size (dispatched {shape.cluster}): "
            + ", ".join(cells))

    # ---- times at the sweep's shapes, bf16 ----
    def time_row(name, p, B, fn, plain, lib, lib_label):
        K, N = shapes[p]
        ms, plain_ms = timer.ms(fn), timer.ms(plain)
        lib_ms = timer.ms(lib) if lib is not None else None
        # x and out in bf16: the W4A8 entries take x as it is
        b_ms, b_by = bound_ms(K // 2 * N + 4 * N + 2 * B * (K + N), 2 * B * K * N,
                              INT8_OPS_PER_S if "w4a8" in name else BF16_FLOPS_PER_S)
        lib_txt = f"{lib_label} {lib_ms:.4f} ms" if lib_ms is not None else f"{lib_label} n/a"
        log(f"{name} {p} B={B} K={K} N={N} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"{lib_txt}, bound {b_ms:.5f} ms ({b_by})")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

    rows = {}
    w4a8_times = {"int4_matmul_w4a8": {}, "int4_matmul_w4a8_stacked": {}}
    w4a16_times = {"int4_matmul": {}, "int4_matmul_stacked": {}}
    _build.reset_launch_counts()
    for B, p in ((1, "qkv"), (1, "o"), (1, "gate_up"), (1, "down"), (8, "gate_up"),
                 (37, "gate_up"), (64, "gate_up")):
        K, N = shapes[p]
        st = stacks[p]
        pk, sc = st["packed"], st["scale"]
        x = x_of(B, K, torch.bfloat16)
        w = (st["codes"][1].float() * sc[1]).to(torch.bfloat16)
        if B in (1, 64):
            for name, fn, plain in (
                ("int4_matmul", lambda: i4.int4_matmul_cuda(x, pk[1], sc[1]),
                 lambda: i4.int4_matmul_plain(x, pk[1], sc[1])),
                ("int4_matmul_stacked", lambda: i4.int4_matmul_stacked_cuda(x, pk, sc, 1),
                 lambda: i4.int4_matmul_stacked_plain(x, pk, sc, 1)),
            ):
                r = time_row(name, p, B, fn, plain, lambda: torch.mm(x, w),
                             "bf16 dense mm (4x the weight bytes)")
                w4a16_times[name][f"{p} B={B}"] = dict(ms=r["ms"], library_ms=r["library_ms"])
                if (B, p) == (1, "gate_up"):
                    rows[name] = dict(r, design=W4A16_DESIGN, times=w4a16_times[name],
                                      threshold=threshold, design_space=space)
        # torch._int_mm takes only B > 16: the yardstick at 37 and 64 rows;
        # below, bf16 torch.mm on the dequantised weight (as for W4A16)
        xq = quantize_activations(x)[0]
        codes_cm = st["codes"][1].t().contiguous().t()  # column-major s8, as cuBLASLt takes it
        lib, lib_label = (((lambda: torch._int_mm(xq, codes_cm)),
                           "torch._int_mm (2x the weight bytes)") if B > 16 else
                          ((lambda: torch.mm(x, w)), "bf16 dense mm (4x the weight bytes)"))
        for name, fn, plain in (
            ("int4_matmul_w4a8", lambda: i4.int4_matmul_w4a8_cuda(x, pk[1], sc[1]),
             lambda: i4.int4_matmul_w4a8_plain(x, pk[1], sc[1])),
            ("int4_matmul_w4a8_stacked", lambda: i4.int4_matmul_w4a8_stacked_cuda(x, pk, sc, 1),
             lambda: i4.int4_matmul_w4a8_stacked_plain(x, pk, sc, 1)),
        ):
            r = time_row(name, p, B, fn, plain, lib, lib_label)
            w4a8_times[name][f"{p} B={B}"] = dict(ms=r["ms"], library_ms=r["library_ms"])
            if (B, p) == (64, "gate_up"):
                rows[name] = dict(r, design=W4A8_DESIGN, times=w4a8_times[name])
    launches = {name: _build.launch_counts[name] for name in INT4_ENTRIES}
    for name in ("int4_matmul_w4a16_mma", "int4_matmul_w4a8_mma"):
        launches[name] = _build.launch_counts[name]
    return errs, rows, launches


def bench_phase(torch):
    """The bench tools' per-step sweeps of nano's decoder projections. Before
    the int4 sweep, one eager step of each int4 kernel variant with the
    launch counters set to 0 just before it and read just after: each
    stacked entry runs 4 times per layer, and the step agrees with the int8
    variant on the same codes. -> {entry: launches in the counted steps}."""
    from sonicscribe_tpu_torch.models.config import nano
    from sonicscribe_tpu_torch.ops import _build
    from sonicscribe_tpu_torch.ops.int4_matmul import w4a8_uses_mma, w4a16_uses_mma
    from sonicscribe_tpu_torch.tools import bench_int4_matmul, bench_int8_matmul

    for rec in bench_int8_matmul.run(batches=(1, 8, 64), reps=10):
        log("bench_int8_matmul " + json.dumps(rec))

    cfg = nano()
    n_layers = cfg.decoder.n_layers
    weights = bench_int4_matmul.make_weights(cfg, SEED, torch.device("cuda"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    h0 = (torch.randn((8, cfg.decoder.d_model), generator=gen, device="cuda") * 0.1
          ).to(torch.bfloat16)
    launches = {}
    with torch.inference_mode():
        ref = bench_int4_matmul.sweep(bench_int4_matmul.VARIANTS["int8"], weights, h0, n_layers)
        for variant, entry in (("int4_w4a16", "int4_matmul_stacked"),
                               ("int4_w4a8", "int4_matmul_w4a8_stacked")):
            _build.reset_launch_counts()
            h = bench_int4_matmul.sweep(bench_int4_matmul.VARIANTS[variant], weights, h0, n_layers)
            torch.cuda.synchronize()
            counts = {k: v for k, v in _build.launch_counts.items() if v}
            want = {entry: 4 * n_layers}
            if variant == "int4_w4a8" and w4a8_uses_mma(h0.shape[0]):
                want["int4_matmul_w4a8_mma"] = 4 * n_layers  # every launch on the tensor cores
            if variant == "int4_w4a16" and w4a16_uses_mma(h0.shape[0], h0.dtype):
                want["int4_matmul_w4a16_mma"] = 4 * n_layers
            check(counts == want, f"bench_int4_matmul {variant}: launches {counts}, want {want} "
                  f"per step")
            rel = ((h.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
            log(f"bench_int4_matmul {variant}: one eager step, B=8: launches {counts}; "
                f"max |step - int8 step| / max |int8 step| {rel:.3g}")
            check(h.shape == ref.shape and bool(torch.isfinite(h).all()) and rel <= SWEEP_TOL,
                  f"bench_int4_matmul {variant}: step differs from the int8 step by {rel}")
            launches[entry] = counts[entry]
            mma = "int4_matmul_w4a8_mma" if variant == "int4_w4a8" else "int4_matmul_w4a16_mma"
            launches[f"{entry}_mma"] = counts.get(mma, 0)
    steps = slice_table_steps(torch, weights, n_layers)
    del weights, ref, h
    for rec in bench_int4_matmul.run(batches=(1, 8, 64), reps=10,
                                     variants=tuple(bench_int4_matmul.VARIANTS)):
        log("bench_int4_matmul " + json.dumps(rec))
    return launches, steps


# the cluster split-K design's slice tables that slice_table_steps compares:
# the shipped ops/int8_matmul.py:CLUSTER_ROWS_PER_CTA, half and twice it
SLICE_TABLES = {"half": 0.5, "shipped": 1.0, "twice": 2.0}


def slice_table_steps(torch, weights, n_layers) -> dict:
    """The cluster split-K design's slice table inside a decode step: the
    int8 (stacked W8A16), int8_w8a8 and int4_w4a16 sweeps of nano's layers
    at the decode rows that reach the design, replayed as a CUDA graph
    (bench_int8_matmul.time_step), under each of SLICE_TABLES in turn, two
    rounds (W8A16 and W4A16 scale CLUSTER_ROWS_PER_CTA, W8A8 its own
    W8A8_CLUSTER_ROWS_PER_CTA). Each step's output is held to the shipped
    table's. -> {"<variant> B=<b>": {table: [ms of each round]}}."""
    from sonicscribe_tpu_torch.ops import int8_matmul as im
    from sonicscribe_tpu_torch.tools import bench_int4_matmul, bench_int8_matmul
    from sonicscribe_tpu_torch.tools.bench_int8_matmul import time_step

    tables = (im.CLUSTER_ROWS_PER_CTA, im.W8A8_CLUSTER_ROWS_PER_CTA)
    shipped = [dict(t) for t in tables]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    d = weights["qkv_w"]["q"].shape[1]
    steps = {}
    try:
        variants = {**bench_int4_matmul.VARIANTS,
                    "int8_w8a8": bench_int8_matmul.VARIANTS["int8_w8a8"]}
        for variant, B in (("int8", 1), ("int8", 8), ("int8_w8a8", 1), ("int8_w8a8", 2),
                           ("int4_w4a16", 1), ("int4_w4a16", 2)):
            h0 = (torch.randn((B, d), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
            mm = variants[variant]
            cell = steps[f"{variant} B={B}"] = {t: [] for t in SLICE_TABLES}
            want = None
            for _ in range(2):
                for table, f in SLICE_TABLES.items():
                    for t, t0 in zip(tables, shipped):
                        t.update({r: int(v * f) for r, v in t0.items()})
                    with torch.inference_mode():
                        h = bench_int4_matmul.sweep(mm, weights, h0, n_layers)
                        if want is None:
                            want = h
                        rel = ((h.float() - want.float()).abs().max()
                               / want.float().abs().max()).item()
                        check(rel <= SWEEP_TOL, f"slice table {table}, {variant} B={B}: the "
                              f"step differs from the shipped table's by {rel}")
                        cell[table].append(time_step(
                            lambda: bench_int4_matmul.sweep(mm, weights, h0, n_layers), 10)[0])
            log(f"slice table in a replayed {variant} step, B={B} (device ms, two rounds): "
                + ", ".join(f"{t} {v[0]:.4f} / {v[1]:.4f}" for t, v in cell.items()))
    finally:
        for t, t0 in zip(tables, shipped):
            t.update(t0)
    return steps


async def _collect(gen) -> list:
    return [m async for m in gen]


def payloads() -> dict:
    return {
        "3s": speech(3.0, 1),
        "12s": speech(12.0, 2),
        "35s": np.concatenate([silence(0.5, 3), speech(24.0, 4), silence(2.0, 5),
                               speech(7.0, 6), silence(1.5, 7)]),
    }


class Recording:
    """The engine as transcribe_file_stream sees it: each transcribe call's
    arguments and tokens are kept, in call order."""

    def __init__(self, engine):
        self.engine = engine
        self.calls = []

    async def transcribe(self, audio, sample_rate, **kw):
        r = await self.engine.transcribe(audio, sample_rate, **kw)
        self.calls.append(dict(audio=audio, sample_rate=sample_rate, kw=kw, tokens=r.tokens))
        return r


def serve_request(torch, engine, vad, config, name: str, audio: np.ndarray,
                  budget: int | None = None, ranks: int = 1) -> dict:
    """One request through the file path (decode_audio +
    transcribe_file_stream), the launch counters set to 0 just before it
    and read just after. Checks the NDJSON stream, the mel launches (one per
    segment and tensor-parallel rank) and the decode-attention launches (one
    per layer per step and rank: through graph replays, the router's
    accounting).
    -> its numbers, the counts and each segment's tokens."""
    from sonicscribe_tpu_torch.audio.wav import write_wav
    from sonicscribe_tpu_torch.ops import _build
    from sonicscribe_tpu_torch.serve.decode import decode_audio
    from sonicscribe_tpu_torch.serve.files import FileTranscriptionConfig, transcribe_file_stream

    n_layers = engine.transcriber.cfg.decoder.n_layers
    wav = write_wav(audio, SR)
    file_cfg = FileTranscriptionConfig.from_dict({}, default_threshold=config.vad_speech_threshold)
    file_cfg.max_new_tokens = budget or config.file_max_new_tokens
    file_cfg.concurrency = engine.concurrency_hint
    steps0, tokens0 = engine.stats["decode_steps"], engine.stats["tokens"]
    rec = Recording(engine)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    decoded = decode_audio(wav, f"{name}.wav", engine.transcriber.device)
    msgs = asyncio.run(_collect(
        transcribe_file_stream(decoded, rec, vad, file_cfg, f"{name}.wav")
    ))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    steps = engine.stats["decode_steps"] - steps0
    tokens = engine.stats["tokens"] - tokens0

    n_seg = msgs[0].get("total_segments", 0)
    types = [m["type"] for m in msgs]
    want = ["initialization", "segments_summary"] + ["segment_result"] * n_seg + ["final_summary"]
    errors = [m for m in msgs if m["type"] == "segment_error"]
    check(not errors, f"{name}: segment errors {errors}")
    check(n_seg >= 1 and types == want, f"{name}: NDJSON types {types}")
    check(counts["log_mel"] == ranks * n_seg,
          f"{name}: log_mel launched {counts['log_mel']} times for {n_seg} segments x "
          f"{ranks} rank(s)")
    check(steps > 0 and counts["decode_attention"] == ranks * n_layers * steps,
          f"{name}: decode_attention launched {counts['decode_attention']} times "
          f"for {steps} decode steps x {n_layers} layers x {ranks} rank(s)")
    duration = len(decoded) / SR
    # segments that decoded their whole budget without an EOS
    at_budget = sum(len(c["tokens"]) == file_cfg.max_new_tokens for c in rec.calls)
    if budget is None:
        log(f"request {name}: {n_seg} segments ({at_budget} ran to the budget), wall "
            f"{wall:.3f} s, RTF {wall / duration:.4f}, {tokens} tokens, "
            f"{tokens / wall:.1f} tokens/s, {steps} decode steps, "
            f"launches { {k: v for k, v in counts.items() if v} }, "
            f"text[:40]={msgs[-1]['full_text'][:40]!r}")
    return dict(msgs=msgs, n_seg=n_seg, steps=steps, counts=counts, wall=wall,
                rtf=wall / duration, tokens=tokens, tokens_per_s=tokens / wall, calls=rec.calls,
                at_budget=at_budget)


def eager_transcriber(tr):
    """A transcriber over `tr`'s weights and settings whose _generate runs
    the eager oracle, assemble_prompt + greedy_generate op by op, in place
    of the captured programs: the "before" of every comparison here and the
    reference of the card tests. The package has no switch for it; this
    subclass is the smoke test's own."""
    import torch

    from sonicscribe_tpu_torch.engine.transcriber import Transcriber, assemble_prompt
    from sonicscribe_tpu_torch.models.glm_asr import greedy_generate

    class EagerTranscriber(Transcriber):
        def _generate(self, bucket, mel, frames, prefix_ids, suffix_ids, suffix_len, budget):
            dev = self.device
            buf, total = assemble_prompt(
                self.params, self.cfg, mel.to(self.dtype),
                torch.tensor([frames], dtype=torch.int32, device=dev),
                torch.from_numpy(prefix_ids).to(dev), torch.from_numpy(suffix_ids).to(dev),
                torch.tensor([suffix_len], dtype=torch.int32, device=dev),
            )
            toks, steps = greedy_generate(self.params, self.cfg, buf, total, budget,
                                          logit_bias=self._bias)
            return toks[0].cpu().numpy(), steps

    return EagerTranscriber(tr.cfg, tr.params, tr.tokenizer, tr.mel_cfg, tr.buckets,
                            tr.peak_normalize, tr.hotword_bias_strength)


def eager_engine(engine):
    """A ThreadedEngine over the same weights and VAD with the eager oracle."""
    from sonicscribe_tpu_torch.serve.engine_async import ThreadedEngine

    return ThreadedEngine(eager_transcriber(engine.transcriber), engine.vad)


def check_same_tokens(name, captured, eager):
    """Each segment's captured tokens equal the eager ones; at the first
    difference, fail with the step and the two tokens there."""
    check(len(captured["calls"]) == len(eager["calls"]) > 0,
          f"{name}: {len(captured['calls'])} captured segments, {len(eager['calls'])} eager")
    for i, (c, e) in enumerate(zip(captured["calls"], eager["calls"])):
        if np.array_equal(c["tokens"], e["tokens"]):
            continue
        n = min(len(c["tokens"]), len(e["tokens"]))
        diff = np.flatnonzero(c["tokens"][:n] != e["tokens"][:n])
        step = int(diff[0]) if len(diff) else n
        tc = int(c["tokens"][step]) if step < len(c["tokens"]) else "end"
        te = int(e["tokens"][step]) if step < len(e["tokens"]) else "end"
        fail(f"{name}: segment {i}: captured tokens differ from eager at step {step}: "
             f"captured {tc}, eager {te} (end: EOS or pad); lengths {len(c['tokens'])}, {len(e['tokens'])}")


def profile_request(torch, engine, vad, config, name: str, audio,
                    attention_checked: bool = True) -> dict:
    """The request at a PROFILE_BUDGET-token budget: its wall unprofiled,
    then a profiled run (torch.profiler, CUDA activity; again while records
    that top_profiles checks are missing: the W8A8 kernels, and the
    decode-attention ones where attention_checked): device busy time
    (kernels only) and idle share, the decode-attention and W8A8 kernels the
    profiler saw beside the wrappers' counts, the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sonicscribe_tpu_torch.ops import _build

    # a first run untimed: the budget's ceiling is in the grid
    serve_request(torch, engine, vad, config, name, audio, budget=PROFILE_BUDGET)
    r = serve_request(torch, engine, vad, config, name, audio, budget=PROFILE_BUDGET)
    # The profiler now and then drops a run of records (eager profiles of
    # ~60k kernels have missed the split and merge kernels of 1-92
    # decode-attention calls, in up to 4 of a run's 9 requests). Every call
    # launches one split and one merge kernel, and every W8A8 call one
    # kernel, so a profile that shows fewer of a checked kernel is
    # incomplete: the request is profiled again.
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            serve_request(torch, engine, vad, config, name, audio, budget=PROFILE_BUDGET)
        counts = dict(_build.launch_counts)
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        seen = [sum(e.count for e in events if f"decode_attention_{part}_kernel" in e.key)
                for part in ("split", "merge")]
        w8a8 = [e for e in events if "w8a8" in e.key.lower()]
        complete = (bool(events) and sum(e.count for e in w8a8) >= counts["int8_matmul_w8a8"]
                    and (not attention_checked or min(seen) >= counts["decode_attention"]))
        if complete or attempt == PROFILE_TRIES:
            break
        log(f"{name}: the profiler lost records ({seen[0]} + {seen[1]} decode-attention "
            f"kernels for {counts['decode_attention']} calls, {sum(e.count for e in w8a8)} "
            f"W8A8 kernels for {counts['int8_matmul_w8a8']}); profiling it again")
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    check(busy_ms > 0, f"{name}: the profiler saw no device time")
    by_part = {part: 0.0 for part in KERNEL_PARTS}
    for e in events:
        part = next((p for p, keys in KERNEL_PARTS.items() if any(k in e.key for k in keys)),
                    "other")
        by_part[part] += dev_us(e) / 1e3
    return dict(wall=r["wall"], busy_ms=busy_ms, idle=max(0.0, 1 - busy_ms / (r["wall"] * 1e3)),
                events=events, w8a8_calls=counts["int8_matmul_w8a8"],
                w8a8_kernels=sum(e.count for e in w8a8), w8a8_us=sum(dev_us(e) for e in w8a8),
                attn_calls=counts["decode_attention"],
                attn_split=seen[0], attn_merge=seen[1],
                n_kernels=sum(e.count for e in events), by_part=by_part, steps=r["steps"],
                tries=attempt)


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))


def compare_requests(torch, engine, eager, vad, config, mode: str, names,
                     eager_names=None) -> dict:
    """Each named request through the captured engine and, where it is one
    of `eager_names` (default: all), the eager one: tokens equal (for 3s
    and 12s a mismatch fails), then wall, RTF, tokens/s, peak memory and,
    from a profile at a PROFILE_BUDGET-token budget, the idle share, side
    by side. -> {name: {label: numbers}}."""
    eager_names = names if eager_names is None else eager_names
    engines = (("captured", engine), ("eager", eager))
    served = {}
    for name in names:
        for label, eng in engines:
            if label == "eager" and name not in eager_names:
                continue
            torch.cuda.reset_peak_memory_stats()
            r = serve_request(torch, eng, vad, config, f"{name} {mode} {label}", payloads()[name])
            served[name, label] = dict(r, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    rows = {}
    for name in names:  # the profiles after every unprofiled run
        runs = {label: dict(served[name, label], profile=profile_request(
            torch, eng, vad, config, f"{name} {mode} {label} profiled", payloads()[name],
            attention_checked=label == "captured"))
            for label, eng in engines if (name, label) in served}
        same = None
        if "eager" in runs:
            same = len(runs["captured"]["calls"]) == len(runs["eager"]["calls"]) and all(
                np.array_equal(c["tokens"], e["tokens"])
                for c, e in zip(runs["captured"]["calls"], runs["eager"]["calls"]))
            if name in ("3s", "12s"):
                check_same_tokens(f"{name} {mode}", runs["captured"], runs["eager"])
        log(f"captured vs eager, {name} {mode}: tokens "
            f"{'not compared (captured only)' if same is None else 'equal' if same else 'DIFFER'}"
            f" ({runs['captured']['tokens']} tokens, {runs['captured']['n_seg']} segments)")
        for label, r in runs.items():
            p = r["profile"]
            log(f"  {label:8s}: wall {r['wall']:.3f} s, RTF {r['rtf']:.4f}, "
                f"{r['tokens_per_s']:.1f} tokens/s, peak {r['peak_gib']:.2f} GiB; "
                f"{PROFILE_BUDGET}-token profile: wall {p['wall'] * 1e3:.1f} ms, device busy "
                f"{p['busy_ms']:.1f} ms, idle share {p['idle']:.3f}, {p['n_kernels']} kernels "
                f"({p['steps']} decode steps); busy ms by part: "
                + ", ".join(f"{k} {v:.1f}" for k, v in p["by_part"].items()))
        rows[name] = {k: {f: v[f] for f in ("wall", "rtf", "tokens", "tokens_per_s", "peak_gib",
                                            "steps", "counts", "n_seg", "at_budget")}
                      | {"idle": v["profile"]["idle"], "busy_ms": v["profile"]["busy_ms"],
                         "busy_by_part_ms": v["profile"]["by_part"],
                         "profile_kernels": v["profile"]["n_kernels"],
                         "profile_wall": v["profile"]["wall"],
                         "long_segment": any(m["is_long_segment"]
                                             for m in v["msgs"][1]["segments"])}
                      for k, v in runs.items()}
        rows[name]["tokens_equal"] = same
        THREADED_TOKENS[mode, name] = [c["tokens"] for c in runs["captured"]["calls"]]
        top_profiles(mode, name, runs)
    return rows


def top_profiles(mode, name, runs) -> None:
    """The top kernels of each profile, and the kernels the profiler saw
    against the wrappers' counts: in the captured profile, whose counts the
    router adds at each replay, one split and one merge kernel per
    decode-attention call; in both, one W8A8 kernel per W8A8 call (B=1).
    The eager profile's decode-attention kernels are printed, not checked:
    the eager 35 s request's profile (~170k kernels and as many launch
    records) has reported 4 fewer of both kernels than the calls.
    profile_request profiles a request again, up to PROFILE_TRIES times,
    while the kernels checked here show records missing."""
    for label, r in runs.items():
        p = r["profile"]
        if name == "3s":
            for e in sorted(p["events"], key=dev_us, reverse=True)[:6]:
                log(f"    {label} {dev_us(e) / 1e3:9.3f} ms {e.count:6d} calls  {e.key[:80]}")
        if label == "captured":
            check(p["attn_calls"] > 0 and p["attn_split"] == p["attn_merge"] == p["attn_calls"],
                  f"{label} profile {name} {mode}: {p['attn_split']} decode-attention split and "
                  f"{p['attn_merge']} merge kernels for {p['attn_calls']} calls")
        check(p["w8a8_kernels"] == p["w8a8_calls"],
              f"{label} profile {name} {mode}: {p['w8a8_kernels']} W8A8 kernels for "
              f"{p['w8a8_calls']} W8A8 calls")
        log(f"  {label} profile {name} {mode}: {p['attn_calls']} decode-attention calls, "
            f"{p['attn_split']} + {p['attn_merge']} kernels; {p['w8a8_calls']} W8A8 calls, "
            f"{p['w8a8_kernels']} kernels (profile {p['tries']} of the request)"
            + (f", {p['w8a8_us'] / p['w8a8_kernels']:.2f} us each" if p["w8a8_kernels"] else ""))


def warm_grid(torch, engine, mode: str) -> dict:
    """Capture the transcriber's graphs for every bucket and GRID_BUDGETS:
    time per key and in all, graphs, and memory with the grid warmed."""
    from sonicscribe_tpu_torch.engine import transcriber as transcriber_module

    tr = engine.transcriber
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.warmup(budgets=GRID_BUDGETS)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    st = tr.router.stats
    for key, sec in st["capture_s"].items():
        log(f"  capture {mode} {key}: {sec:.3f} s")
    out = dict(grid_s=total, graphs=st["graphs"],
               max_gib=torch.cuda.max_memory_allocated() / 2**30,
               resident_gib=torch.cuda.memory_allocated() / 2**30,
               capture_s={str(k): v for k, v in st["capture_s"].items()})
    log(f"grid {mode}: {out['graphs']} graphs (buckets {tr.buckets}, budgets {GRID_BUDGETS}, "
        f"{transcriber_module.DECODE_STEPS} steps per decode graph) captured in {total:.2f} s; "
        f"max_memory_allocated {out['max_gib']:.2f} GiB, resident {out['resident_gib']:.2f} GiB")
    return out


def main_path_phase(torch):
    """nano-random native: the grid captured, then the three requests
    captured (counted: the main path) and eager."""
    from sonicscribe_tpu_torch.config import AppConfig
    from sonicscribe_tpu_torch.serve.runtime import build_runtime

    config = AppConfig()
    t0 = time.perf_counter()
    engine, vad, info = build_runtime("nano-random", "energy", config, seed=SEED,
                                      engine_kind="threaded")
    torch.cuda.synchronize()
    log(f"nano-random on {info['device_name']}: {info['params']} params, "
        f"init {time.perf_counter() - t0:.1f} s, resident "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    eager = eager_engine(engine)
    try:
        torch.cuda.reset_peak_memory_stats()
        grid = warm_grid(torch, engine, "native")
        launches = {"decode_attention": 0, "log_mel": 0}
        # the ~35 s request runs captured only: its eager run and profile
        # (~30 s) were the script's largest single item
        rows = compare_requests(torch, engine, eager, vad, config, "native", ("3s", "12s", "35s"),
                                eager_names=("3s", "12s"))
        for name, row in rows.items():
            for kname in launches:
                launches[kname] += row["captured"]["counts"][kname]
        r35 = rows["35s"]["captured"]
        check(r35["n_seg"] >= 3 and r35["long_segment"],
              f"35s: expected a VAD split and a long-segment cut, got {r35['n_seg']} segments")
        return engine, launches, dict(grid=grid, requests=rows)
    except BaseException:
        engine.shutdown()
        raise
    finally:
        eager.shutdown()


def cut_transcriber(tr, n_layers: int):
    """A Transcriber over the first n_layers decoder layers of `tr` (its
    weights as build_runtime made and quantized them)."""
    from dataclasses import replace

    from sonicscribe_tpu_torch.engine.transcriber import Transcriber

    def first(tree):
        return {k: first(v) for k, v in tree.items()} if isinstance(tree, dict) \
            else tree[:n_layers]

    cfg = replace(tr.cfg, decoder=replace(tr.cfg.decoder, n_layers=n_layers))
    params = dict(tr.params, decoder=dict(tr.params["decoder"],
                                          layers=first(tr.params["decoder"]["layers"])))
    return Transcriber(cfg, params, tr.tokenizer, mel_cfg=tr.mel_cfg, prefill_buckets=tr.buckets)


def cut_depth(engine, n_layers: int):
    """A ThreadedEngine over the first n_layers decoder layers of `engine`'s
    transcriber."""
    from sonicscribe_tpu_torch.serve.engine_async import ThreadedEngine

    engine.shutdown()
    return ThreadedEngine(cut_transcriber(engine.transcriber, n_layers), engine.vad)


def cut_batched(engine, n_layers: int):
    """`engine` (a BatchedEngine) rebuilt over the first n_layers decoder
    layers of its transcriber, with its sizes and fusion."""
    from sonicscribe_tpu_torch.engine.batcher import BatchedEngine

    engine.shutdown()
    cut = BatchedEngine(cut_transcriber(engine.transcriber, n_layers), engine.vad,
                        slots=len(engine.long.slots), max_decode_tokens=engine.MAX_NEW,
                        n_streams=engine.N_STREAMS, fuse_dual_decode=engine.fuse_dual)
    return cut


def int8_main_path_phase(torch, mode: str) -> tuple[dict, dict]:
    """build_runtime in one int8 mode, cut to INT8_THREADED_LAYERS decoder
    layers, its grid captured, then the ~3 s and ~12 s requests captured
    and eager; checks the int8 kernels' launch counts in both. -> (the
    captured 12 s request's launch counts, numbers)."""
    from sonicscribe_tpu_torch.config import AppConfig
    from sonicscribe_tpu_torch.serve.runtime import build_runtime

    config = AppConfig()
    config.quant_mode = mode
    t0 = time.perf_counter()
    engine, vad, info = build_runtime("nano-random", "energy", config, seed=SEED,
                                      engine_kind="threaded")
    engine = cut_depth(engine, INT8_THREADED_LAYERS)
    gc.collect()
    torch.cuda.synchronize()
    log(f"nano-random {mode}, cut to {INT8_THREADED_LAYERS} decoder layers: {info['params']} "
        f"params before the cut, init {time.perf_counter() - t0:.1f} s, resident "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    eager = eager_engine(engine)
    try:
        torch.cuda.reset_peak_memory_stats()
        grid = warm_grid(torch, engine, mode)
        rows = compare_requests(torch, engine, eager, vad, config, mode, ("3s", "12s"))
        cfg = engine.transcriber.cfg
        n_dec, n_enc = cfg.decoder.n_layers, cfg.encoder.n_layers
        decode_entry = "int8_matmul_w8a8" if mode == "int8-decoder-a8" else "int8_matmul_stacked"
        other = "int8_matmul_stacked" if mode == "int8-decoder-a8" else "int8_matmul_w8a8"
        for label in ("captured", "eager"):
            r = rows["12s"][label]
            counts, steps, n_seg = r["counts"], r["steps"], r["counts"]["log_mel"]
            check(counts[decode_entry] == 4 * n_dec * steps and counts[other] == 0,
                  f"{mode} {label}: {decode_entry} launched {counts[decode_entry]} times for "
                  f"{steps} decode steps x {n_dec} layers x 4 ({other}: {counts[other]})")
            flat = n_seg * (4 * n_dec + (6 * n_enc if mode == "int8" else 0))
            check(counts["int8_matmul"] == flat,
                  f"{mode} {label}: int8_matmul launched {counts['int8_matmul']} times, "
                  f"want {flat}")
            # every flat launch here is bf16 prefill or encoder rows (B > 8); the
            # decode step's one row takes W8A8's cluster design
            check(counts["int8_matmul_mma"] == flat,
                  f"{mode} {label}: int8_matmul_mma launched {counts['int8_matmul_mma']} times, "
                  f"want {flat}")
            check(counts["int8_matmul_w8a8_mma"] == 0,
                  f"{mode} {label}: W8A8 took the tensor cores {counts['int8_matmul_w8a8_mma']} "
                  f"times at B=1")
        return rows["12s"]["captured"]["counts"], dict(grid=grid, requests=rows)
    finally:
        eager.shutdown()
        engine.shutdown()


def concurrent_capture_phase(torch) -> None:
    """/transcribe/file resamples uploads on the card in another thread
    while the engine thread may capture: tiny f32 graphs captured while a
    thread resamples on the card give the tokens of graphs captured alone."""
    import threading

    from sonicscribe_tpu_torch.audio.resample import resample

    alone, busy = (tiny_transcriber(torch, "cuda") for _ in range(2))
    audio = speech(2.2, seed=21)
    want = alone.transcribe(audio, SR, max_new_tokens=24).tokens
    stop, errors, runs = threading.Event(), [], [0]
    upload = torch.from_numpy(speech(3.0, seed=22))

    def resampling():
        try:
            while not stop.is_set():
                resample(upload.cuda(), 44100, SR).cpu()
                runs[0] += 1
        except Exception as e:  # reported below
            errors.append(e)

    thread = threading.Thread(target=resampling)
    thread.start()
    try:
        busy.warmup(budgets=(24,))
        got = busy.transcribe(audio, SR, max_new_tokens=24).tokens
    finally:
        stop.set()
        thread.join(timeout=60)
    check(not thread.is_alive() and not errors and runs[0] > 0,
          f"the resampling thread: alive {thread.is_alive()}, errors {errors}, runs {runs[0]}")
    check(len(want) > 0 and np.array_equal(got, want),
          f"tiny graphs captured beside a resampling thread: tokens {got}, alone {want}")
    log(f"captured {busy.router.stats['graphs']} tiny graphs while another thread resampled "
        f"{runs[0]} uploads on the card: tokens equal to graphs captured alone")


def tiny_params(torch, mode: str = "native"):
    """tiny() f32 from seed SEED + 1, x4 so the random model's tokens vary,
    on the CPU and on the card; in an int8 mode each tree quantized on its
    own device, as build_runtime quantizes it. -> (cfg, {device: tree})."""
    from dataclasses import replace

    from sonicscribe_tpu_torch.models.config import tiny
    from sonicscribe_tpu_torch.models.weights import init_random
    from sonicscribe_tpu_torch.ops.quant import quantize_params_int8

    cfg = tiny()

    def mapped(tree, fn):
        if isinstance(tree, dict):
            return {k: mapped(v, fn) for k, v in tree.items()}
        return fn(tree)

    params = mapped(init_random(cfg, seed=SEED + 1, dtype=torch.float32, device="cpu"),
                    lambda t: t * 4.0)
    trees = {d: mapped(params, lambda t, d=d: t.to(d)) for d in ("cpu", "cuda")}
    if mode != "native":
        trees = {d: quantize_params_int8(t, decoder_only=mode != "int8") for d, t in trees.items()}
        if mode == "int8-decoder-a8":
            cfg = replace(cfg, decoder=replace(cfg.decoder, act_int8_decode=True))
    return cfg, trees


def tiny_transcriber(torch, device: str, mode: str = "native"):
    from sonicscribe_tpu_torch.engine.transcriber import Transcriber
    from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer

    cfg, trees = tiny_params(torch, mode)
    return Transcriber(cfg, trees[device], ByteTokenizer(cfg), prefill_buckets=(128, 256))


def tiny_tokens_phase(torch, mode: str = "native"):
    """tiny() f32 in `mode` gives the same tokens on the card (the captured
    graphs, kernels) as on the CPU (the same programs run eagerly, plain
    versions), from the same float32 tree, with k = 1 and 8 decode steps
    per graph and a budget of 21 (no multiple of 8: on ceiling 200's graph)."""
    from sonicscribe_tpu_torch.engine import transcriber as tm
    from sonicscribe_tpu_torch.engine.transcriber import Transcriber
    from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
    from sonicscribe_tpu_torch.ops import _build

    cfg, trees = tiny_params(torch, mode)
    trs = {d: Transcriber(cfg, t, ByteTokenizer(cfg), prefill_buckets=(128, 256))
           for d, t in trees.items()}
    _build.reset_launch_counts()
    shipped = tm.DECODE_STEPS
    try:
        for k in (1, 8):
            tm.DECODE_STEPS = k
            for sec, sr in ((1.3, 16000), (2.2, 16000)):
                audio = speech(sec, seed=20)
                a = trs["cpu"].transcribe(audio, sr, max_new_tokens=21)
                b = trs["cuda"].transcribe(audio, sr, max_new_tokens=21)
                check(len(a.tokens) > 0 and np.array_equal(a.tokens, b.tokens),
                      f"tiny f32 {mode} k={k} tokens differ: cpu {a.tokens} cuda {b.tokens}")
                log(f"reference: tiny f32 {mode} {sec} s, k={k}, budget 21: {len(a.tokens)} "
                    f"tokens equal on cuda (captured) and cpu")
    finally:
        tm.DECODE_STEPS = shipped
    keys = sorted(k for k in trs["cuda"].router.entries if k[0] == "decode")
    # budget 21 runs on ceiling 200's graphs (bucket 256 here), one per k,
    # and no tail graph
    check(keys == [("decode", 256, 200, k, 3) for k in (1, 8)],
          f"tiny {mode}: decode graphs {keys}")
    if mode != "native":
        decode_entry = "int8_matmul_w8a8" if mode == "int8-decoder-a8" else "int8_matmul_stacked"
        check(_build.launch_counts[decode_entry] > 0 and _build.launch_counts["int8_matmul"] > 0,
              f"tiny {mode}: the int8 kernels did not run on the card: {_build.launch_counts}")


def reference_phase(torch, engine):
    """tiny() f32: card vs CPU tokens; nano prefill logits finite."""
    from sonicscribe_tpu_torch.audio.mel import log_mel_spectrogram
    from sonicscribe_tpu_torch.engine.transcriber import MAX_SUFFIX_TOKENS, assemble_prompt
    from sonicscribe_tpu_torch.models.glm_asr import prefill_kv
    from sonicscribe_tpu_torch.models.tokenizer import build_prompt

    tiny_tokens_phase(torch)
    tiny_stream_phase(torch)
    concurrent_capture_phase(torch)
    tr = engine.transcriber
    x = torch.from_numpy(speech(3.0, 30)).cuda()
    mel = log_mel_spectrogram(x, tr.mel_cfg, pad_to_frames=512)[None].to(tr.dtype)
    prompt = build_prompt(tr.tokenizer, tr.cfg)
    suffix = np.full((MAX_SUFFIX_TOKENS,), tr.cfg.pad_id, np.int32)
    suffix[: len(prompt.suffix_ids)] = prompt.suffix_ids
    with torch.inference_mode():
        buf, total = assemble_prompt(
            tr.params, tr.cfg, mel, torch.tensor([300], dtype=torch.int32, device="cuda"),
            torch.from_numpy(prompt.prefix_ids).cuda(), torch.from_numpy(suffix).cuda(),
            torch.tensor([len(prompt.suffix_ids)], dtype=torch.int32, device="cuda"),
        )
        _, _, logits = prefill_kv(tr.params, tr.cfg, buf, total)
    check(tuple(logits.shape) == (1, tr.cfg.decoder.vocab_size) and logits.dtype == torch.float32,
          f"nano logits {tuple(logits.shape)} {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), "nano prefill logits are not finite")
    log("reference: nano prefill logits finite, shape", tuple(logits.shape))


# ---------------------------------------------------------------------
# the stream: StreamSession on ThreadedEngine, without aiohttp
# ---------------------------------------------------------------------

# (signal, seconds) of the stream: three utterances, the last longer than
# max_segment_duration (20 s), so that it is committed as _part_0, _part_1;
# 2 s of silence give the gate its two silent windows (1.5 s may give one)
STREAM_SPANS = (("silence", 1.0), ("speech", 4.0), ("silence", 2.0), ("speech", 9.0),
                ("silence", 2.0), ("speech", 22.0), ("silence", 2.0))
# the tiny f32 card-vs-CPU stream: two utterances, eager finals
TINY_STREAM_SPANS = (("silence", 0.7), ("speech", 2.3), ("silence", 2.0), ("speech", 1.4),
                     ("silence", 2.0))
CHUNK_SAMPLES = 1024  # a 2048-byte PCM16 frame
VAD_TOL = 1e-6  # a window's probability: float32 band energies from another matmul shape


def stream_frames(spans, seed: int) -> tuple[list[bytes], np.ndarray, list[int]]:
    """-> (2048-byte PCM16 frames of the spans, the float32 samples the
    session decodes from them, the last frame of each speech span)."""
    parts, ends, n = [], [], 0
    for i, (kind, sec) in enumerate(spans):
        parts.append((speech if kind == "speech" else silence)(sec, seed + i))
        n += len(parts[-1])
        if kind == "speech":
            ends.append((n - 1) // CHUNK_SAMPLES)
    x = np.concatenate(parts)
    x = np.concatenate([x, np.zeros(-len(x) % CHUNK_SAMPLES, np.float32)])
    pcm = (np.clip(x, -1, 1) * 32767).astype("<i2")
    frames = [pcm[i : i + CHUNK_SAMPLES].tobytes() for i in range(0, len(pcm), CHUNK_SAMPLES)]
    return frames, pcm.astype(np.float32) / 32768.0, ends


def gate_commits(window_p: np.ndarray, config) -> list[dict]:
    """The committed outputs the gate implies for these window
    probabilities, with the session's rules (serve/session.py): the segment
    backdated to its first window; an eager final over [start, first silent
    window] committed at the second; above max_segment_duration, chunk-
    aligned parts. -> [{segment_id, start, end (the message's chunk ids),
    lo, hi (the decoded chunks), budget}]."""
    from sonicscribe_tpu_torch.vad.gate import VadGate, VadGateConfig

    gate = VadGate(VadGateConfig(
        process_window=config.vad_process_window, smoothing_window=config.vad_smoothing_window,
        base_threshold=config.vad_dynamic_base_threshold,
        max_threshold=config.vad_dynamic_max_threshold,
        start_boost=config.vad_dynamic_start_boost,
        continue_boost=config.vad_dynamic_continue_boost))
    chunk_s, max_d, w = config.audio_chunk_duration_ms / 1000.0, config.max_segment_duration, \
        config.vad_process_window
    out, start, eager, seg_id = [], None, None, 0
    for i, p in enumerate(window_p):
        ev = gate.update(float(p), w * i, w * i + w - 1)
        if ev.state_changed and ev.speech_start_chunk is not None:
            start, eager = ev.speech_start_chunk, None
        elif ev.state_changed and ev.speech_end_chunk is not None:
            end = ev.speech_end_chunk
            d = (end - start + 1) * chunk_s
            if eager is not None and d <= max_d:
                out.append(dict(segment_id=str(seg_id), start=start, end=end, lo=start,
                                hi=eager, budget=config.final_token_budget(
                                    (eager - start + 1) * chunk_s)))
            elif d <= max_d:
                out.append(dict(segment_id=str(seg_id), start=start, end=end, lo=start, hi=end,
                                budget=config.final_token_budget(d)))
            else:
                n_parts = int(d // max_d) + (1 if d % max_d else 0)
                per = max(1, (end - start + 1) // n_parts)
                for j in range(n_parts):
                    lo = start + j * per
                    hi = end if j == n_parts - 1 else lo + per - 1
                    out.append(dict(segment_id=f"{seg_id}_part_{j}", start=lo, end=hi, lo=lo,
                                    hi=hi, budget=config.final_token_budget((hi - lo + 1) * chunk_s)))
            seg_id, start, eager = seg_id + 1, None, None
        elif gate.is_speaking:
            if ev.resumed:
                eager = None
            if (ev.maybe_end_chunk is not None and config.eager_finals and eager is None
                    and (ev.maybe_end_chunk - start + 1) * chunk_s <= max_d):
                eager = ev.maybe_end_chunk
    return out


class Tracked:
    """An engine as a session sees it, counting its calls in flight, so that
    the caller can wait until the session is idle. Everything else (the
    ring's alloc_stream, ingest, free_stream, interim_stagger, has_ring on
    a ring engine) is the engine's own."""

    def __init__(self, engine):
        self.engine = engine
        self.busy = 0

    def __getattr__(self, name):
        return getattr(self.engine, name)

    async def _counted(self, call):
        self.busy += 1
        try:
            return await call
        finally:
            self.busy -= 1

    async def vad_window_prob(self, audio, state):
        return await self._counted(self.engine.vad_window_prob(audio, state))

    async def transcribe(self, audio, sample_rate, **kw):
        return await self._counted(self.engine.transcribe(audio, sample_rate, **kw))

    async def vad_window_ring(self, stream_idx, start_chunk):
        return await self._counted(self.engine.vad_window_ring(stream_idx, start_chunk))

    async def transcribe_ring(self, *args, **kw):
        return await self._counted(self.engine.transcribe_ring(*args, **kw))


async def settle(session, engine: Tracked) -> None:
    """Until the session's VAD queue is empty, no engine call is in flight
    and every task it spawned is done, three polls in a row."""
    quiet = 0
    while quiet < 3:
        await asyncio.sleep(0.001)
        idle = (session._vad_queue.empty() and engine.busy == 0
                and all(t.done() for t in session._tasks))
        quiet = quiet + 1 if idle else 0


async def drive_stepped(config, engine, frames) -> list[dict]:
    """The frames through one StreamSession on a stepped clock (64 ms a
    frame), each window's work done before the next frame, then the close
    path (flush, cleanup). -> the messages without processing_delay."""
    from sonicscribe_tpu_torch.serve.session import StreamSession

    msgs, now = [], [0.0]

    async def send(m):
        msgs.append(m)

    tracked = Tracked(engine)
    session = StreamSession("tiny", config, tracked, send, clock=lambda: now[0])
    for i, frame in enumerate(frames):
        now[0] = i * config.audio_chunk_duration_ms / 1000.0
        await session.on_audio(frame)
        await settle(session, tracked)
    await session.flush()
    await session.cleanup()
    return [{k: v for k, v in m.items() if k != "processing_delay"} for m in msgs]


def tiny_stream_phase(torch) -> None:
    """tiny() f32: the same frames through a session on the card (graph
    replays, kernels) and one on the CPU (plain versions), each on a stepped
    clock with every VAD window awaited: the same messages."""
    from sonicscribe_tpu_torch.config import AppConfig
    from sonicscribe_tpu_torch.serve.engine_async import ThreadedEngine
    from sonicscribe_tpu_torch.vad.model import EnergyVad

    frames, _, _ = stream_frames(TINY_STREAM_SPANS, seed=50)
    got = {}
    for device in ("cpu", "cuda"):
        engine = ThreadedEngine(tiny_transcriber(torch, device), EnergyVad(device=device))
        try:
            got[device] = asyncio.run(drive_stepped(AppConfig(), engine, frames))
        finally:
            engine.shutdown()
    kinds = [m["type"] for m in got["cpu"]]
    check(got["cuda"] == got["cpu"], "tiny f32 stream: the card's messages differ from the "
          f"CPU's:\n  cuda {got['cuda']}\n  cpu  {got['cpu']}")
    check(kinds.count("committed_output") == 2 and "tentative_output" in kinds,
          f"tiny f32 stream: messages {kinds}")
    log(f"reference: tiny f32 stream, {len(frames)} frames: {kinds.count('tentative_output')} "
        f"tentative and {kinds.count('committed_output')} committed messages equal on cuda "
        f"(captured) and cpu")


class ErrorCount(logging.Handler):
    """Counts the records at ERROR and above (the session logs a failed
    decode or VAD window with logger.exception and goes on)."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(self.format(record))
        log(f"stream: {self.records[-1]}")


def stream_phase(torch, engine, grid: dict) -> dict:
    """The nano-random native runtime, its grid warmed, serves one realtime
    stream (STREAM_SPANS, ~42 s) through StreamSession at real-time pace,
    2048-byte frames every 64 ms; launch counters set to 0 just before and
    read just after. Checks: the committed segments and parts the gate
    implies; no graph captured; each committed text is a standalone
    transcribe of the same audio at the same budget; each window's VAD
    probability is the max of window_probs over its samples; log_mel once
    per interim and final; decode attention 28 times per decode step; no
    failed decode. -> the stream's numbers and launch counts."""
    from sonicscribe_tpu_torch.config import AppConfig
    from sonicscribe_tpu_torch.ops import _build
    from sonicscribe_tpu_torch.serve.session import StreamSession
    from sonicscribe_tpu_torch.vad.model import WINDOW_SAMPLES, window_probs

    config = AppConfig()
    tr, vad = engine.transcriber, engine.vad
    frames, samples, speech_ends = stream_frames(STREAM_SPANS, seed=40)
    w = config.vad_process_window
    n_windows, per = len(frames) // w, w * CHUNK_SAMPLES // WINDOW_SAMPLES
    sub = window_probs(vad, samples)[: n_windows * per].reshape(n_windows, per)
    want = gate_commits(sub.max(axis=1), config)
    check(len(want) == 4, f"stream: the gate implies {[c['segment_id'] for c in want]}")

    msgs, arrivals, calls, vad_calls, attempts = [], [], [], [], [0]

    async def send(m):
        msgs.append(m)
        arrivals.append(time.perf_counter())

    transcribe, vad_window_prob, vad_window = (engine.transcribe, engine.vad_window_prob,
                                               engine._vad_window)

    async def recorded_transcribe(audio, sample_rate, **kw):
        r = await transcribe(audio, sample_rate, **kw)
        calls.append(dict(audio=audio, budget=kw["max_new_tokens"], tokens=r.tokens, text=r.text))
        return r

    async def timed_vad_window_prob(audio, state):
        call = dict(submit=time.perf_counter())
        vad_calls.append(call)
        p, state = await vad_window_prob(audio, state)
        call["prob"] = p
        return p, state

    def timed_vad_window(audio, state):
        t0 = time.perf_counter()
        out = vad_window(audio, state)
        vad_calls[-1].update(start=t0, end=time.perf_counter())
        return out

    errors = ErrorCount()
    session_log = logging.getLogger("sonicscribe_tpu_torch.serve.session")
    session_log.addHandler(errors)
    engine.transcribe, engine.vad_window_prob = recorded_transcribe, timed_vad_window_prob
    engine._vad_window = timed_vad_window

    async def run():
        session = StreamSession("stream", config, engine, send)
        run_interim = session._run_interim

        async def counted_interim(*a):
            attempts[0] += 1
            await run_interim(*a)

        session._run_interim = counted_interim
        t0 = time.perf_counter()
        sent = []
        for i, frame in enumerate(frames):
            await asyncio.sleep(max(0.0, t0 + i * 0.064 - time.perf_counter()))
            sent.append(time.perf_counter())
            await session.on_audio(frame)
        for _ in range(1200):  # the last final: at most 60 s more
            if sum(m["type"] == "committed_output" for m in msgs) >= len(want):
                break
            await asyncio.sleep(0.05)
        await session.flush()
        await session.cleanup()
        return session, sent, time.perf_counter() - t0

    graphs0, steps0 = tr.router.stats["graphs"], tr.stats["decode_steps"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident0 = torch.cuda.memory_allocated()
    _build.reset_launch_counts()
    try:
        session, sent, wall = asyncio.run(run())
        torch.cuda.synchronize()
    finally:
        del engine.transcribe, engine.vad_window_prob, engine._vad_window
        session_log.removeHandler(errors)
    counts = dict(_build.launch_counts)
    steps = tr.stats["decode_steps"] - steps0
    captured = tr.router.stats["graphs"] - graphs0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    resident_gib = torch.cuda.memory_allocated() / 2**30

    check(not errors.records, f"stream: {len(errors.records)} failed calls: {errors.records[:2]}")
    committed = [m for m in msgs if m["type"] == "committed_output"]
    tentative = [m for m in msgs if m["type"] == "tentative_output"]
    check([(m["segment_id"], m["start_chunk_id"], m["end_chunk_id"]) for m in committed]
          == [(c["segment_id"], c["start"], c["end"]) for c in want],
          f"stream: committed {[(m['segment_id'], m['start_chunk_id'], m['end_chunk_id']) for m in committed]}"
          f", the gate implies {[(c['segment_id'], c['start'], c['end']) for c in want]}")
    check(captured == 0, f"stream: {captured} graphs captured during the stream")
    finals = [c for c in calls if c["budget"] != config.interim_max_new_tokens]
    interims = len(calls) - len(finals)
    check(len(finals) == len(want), f"stream: {len(finals)} final decodes for {len(want)} commits")
    spc = CHUNK_SAMPLES
    for c, m, f in zip(want, committed, finals):
        audio = samples[c["lo"] * spc : (c["hi"] + 1) * spc]
        check(f["budget"] == c["budget"] and np.array_equal(f["audio"], audio),
              f"stream {c['segment_id']}: decoded {len(f['audio'])} samples at budget "
              f"{f['budget']}, want chunks {c['lo']}-{c['hi']} at {c['budget']}")
        alone = tr.transcribe(audio, SR, max_new_tokens=c["budget"])
        check(np.array_equal(alone.tokens, f["tokens"]) and alone.text == m["text"],
              f"stream {c['segment_id']}: committed {len(f['tokens'])} tokens / {m['text']!r}, "
              f"standalone {len(alone.tokens)} / {alone.text!r}")
    probs = np.array([v["prob"] for v in vad_calls])
    err = float(np.abs(probs - sub[: len(probs)].max(axis=1)).max())
    check(len(probs) == n_windows and err <= VAD_TOL,
          f"stream: {len(probs)} VAD windows for {n_windows}, max |p - window_probs| {err}")
    check(counts["log_mel"] == len(calls),
          f"stream: log_mel launched {counts['log_mel']} times for {len(calls)} decodes")
    n_layers = tr.cfg.decoder.n_layers
    check(steps > 0 and counts["decode_attention"] == n_layers * steps,
          f"stream: decode_attention launched {counts['decode_attention']} times for {steps} "
          f"decode steps x {n_layers} layers")

    def pct(xs, q):
        return float(np.percentile(xs, q)) if len(xs) else None

    delays = [m["processing_delay"] for m in tentative]
    # speech end: the send of the last frame of the span that the commit closes
    span_end = {}
    for c in want:
        span_end[c["segment_id"]] = next(e for e in speech_ends if e >= c["start"])
    end_to_commit = [arrivals[msgs.index(m)] - sent[span_end[m["segment_id"]]] for m in committed]
    vad_run = [v["end"] - v["start"] for v in vad_calls]
    vad_wait = [v["start"] - v["submit"] for v in vad_calls]
    out = dict(
        frames=len(frames), audio_s=len(frames) * 0.064, wall_s=wall, buffer=session.buffer.backend,
        commits=[dict(segment_id=c["segment_id"], chunks=[c["lo"], c["hi"]], budget=c["budget"])
                 for c in want],
        interims_sent=len(tentative), interims_dropped=attempts[0] - interims,
        interim_decodes=interims, final_decodes=len(finals), decode_steps=steps,
        graphs_captured=captured,
        tentative_delay_p50_s=pct(delays, 50), tentative_delay_p95_s=pct(delays, 95),
        speech_end_to_committed_p50_s=pct(end_to_commit, 50),
        speech_end_to_committed_max_s=max(end_to_commit),
        confirm_to_committed_s=[m["processing_delay"] for m in committed],
        vad_windows=len(vad_calls), vad_max_abs_err=err,
        vad_run_p50_ms=pct(vad_run, 50) * 1e3, vad_run_max_ms=max(vad_run) * 1e3,
        vad_wait_p50_ms=pct(vad_wait, 50) * 1e3, vad_wait_p95_ms=pct(vad_wait, 95) * 1e3,
        vad_wait_max_ms=max(vad_wait) * 1e3,
        resident_gib=resident_gib, resident_before_gib=resident0 / 2**30, peak_gib=peak_gib,
        grid_s=grid["grid_s"], grid_graphs=grid["graphs"],
        grid_200_capture_s=sum(v for k, v in grid["capture_s"].items() if ", 200, " in k),
        launches={k: v for k, v in counts.items() if v})
    log(f"stream: {out['frames']} frames ({out['audio_s']:.1f} s) in {wall:.2f} s, "
        f"{len(committed)} committed {[m['segment_id'] for m in committed]} (budgets "
        f"{[c['budget'] for c in want]}), texts equal to standalone transcribes, "
        f"{out['interims_sent']} interims sent, {out['interims_dropped']} dropped; "
        f"0 graphs captured; {len(vad_calls)} VAD windows within {err:.2e} of window_probs; "
        f"buffer {out['buffer']}")
    return out


# ---------------------------------------------------------------------
# the batched engine: kernels at its shapes, files, streams, decode runs
# ---------------------------------------------------------------------


def short_pool_len() -> int:
    """The nano short pool's cache length: 3 prefix + 128 / 8 audio tokens
    + the default suffix bucket + a 16-token budget (engine/batcher.py)."""
    from sonicscribe_tpu_torch.engine.transcriber import MAX_SUFFIX_TOKENS
    from sonicscribe_tpu_torch.models.config import nano
    from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer, build_prompt

    cfg = nano()
    n = len(build_prompt(ByteTokenizer(cfg), cfg).suffix_ids)
    return 3 + 128 // cfg.frames_per_audio_token + min(MAX_SUFFIX_TOKENS, (n + 9) // 8 * 8) + 16


def batched_kernel_phase(torch, timer) -> dict:
    """The kernels at the shapes the batcher gives them, against their plain
    versions: decode attention at S 33, M 803 (the full long pool) and S 65,
    M = the short pool's length, lens mixed with 0 for empty slots (f32 and
    bf16, ATTN_TOL), and timed there in bf16 beside the plain version, SDPA
    with a mask and the bound; the batched log-mel (one launch for B rows) at
    B 1, 4 and 32 rows of 20 chunks (the interim ring prefill) and 4 rows of
    480 (the largest chunk bucket), each row normalized on its own, within
    MEL_TOL, timed at B 32; the stacked W8A16 entry at B 16, 33 and 65 (bf16:
    the tensor-core design) within its tolerance, and W8A8 at B 4, 16, 33 and
    65 equal to the recipe on CPU copies. -> {kernel: numbers}."""
    import torch.nn.functional as F

    from sonicscribe_tpu_torch.audio.mel import MelConfig, device_tables
    from sonicscribe_tpu_torch.models.config import nano
    from sonicscribe_tpu_torch.ops import _build
    from sonicscribe_tpu_torch.ops import int8_matmul as im
    from sonicscribe_tpu_torch.ops.decode_attention import (
        decode_attention_cuda,
        decode_attention_plain,
    )
    from sonicscribe_tpu_torch.ops.mel import log_mel_frames_cuda, log_mel_frames_plain
    from sonicscribe_tpu_torch.ops.quant import quantize_tensor

    dec = nano().decoder
    nh, nkv, hd = dec.n_heads, dec.n_kv_heads, dec.head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    out = {}

    # ---- decode attention at the pools' shapes ----
    attn_err, attn = 0.0, {}
    for S, M in ((33, 803), (65, short_pool_len())):
        lens_list = torch.randint(0, M, (S,), generator=gen, device="cuda")
        lens_list[::3] = 0  # empty slots
        lens_list[1] = M - 1
        lens = lens_list.to(torch.int32)
        for dtype in (torch.float32, torch.bfloat16):
            k = torch.randn((2, S, M, nkv, hd), generator=gen, device="cuda").to(dtype)[1]
            v = torch.randn((2, S, M, nkv, hd), generator=gen, device="cuda").to(dtype)[1]
            q = torch.randn((S, nh, hd), generator=gen, device="cuda").to(dtype)
            err = (decode_attention_cuda(q, k, v, lens) - decode_attention_plain(q, k, v, lens)
                   ).abs().max().item()
            check(np.isfinite(err) and err <= ATTN_TOL,
                  f"decode_attention S={S} M={M} {dtype} mixed lens: max err {err} > {ATTN_TOL}")
            attn_err = max(attn_err, err)
        kq, vq = k.transpose(1, 2), v.transpose(1, 2)  # [S, nkv, M, hd] views
        mask = (torch.arange(M, device="cuda")[None, :] <= lens[:, None])[:, None, None, :]
        ms = timer.ms(lambda: decode_attention_cuda(q, k, v, lens))
        plain_ms = timer.ms(lambda: decode_attention_plain(q, k, v, lens))
        lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kq, vq, attn_mask=mask, enable_gqa=True))
        pos = float((lens.long() + 1).sum())
        n_bytes = S * (nh * hd * 2 + nh * hd * 4 + 4) + pos * 2 * nkv * hd * 2
        b_ms, b_by = bound_ms(n_bytes, 4 * nh * hd * pos)
        log(f"decode_attention S={S} M={M} mixed lens ({int((lens == 0).sum())} empty, "
            f"{int(pos)} positions) bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
            f"(masked) {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        attn[f"S{S}_M{M}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                                  bound_by=b_by)
    out["decode_attention"] = dict(max_abs_err=attn_err, shapes=attn)

    # ---- the batched log-mel ----
    cfg = MelConfig()
    basis, fb = device_tables(cfg, torch.device("cuda"))

    def normalized(raw):  # log_mel_batch's per-row clamp and scaling (full rows)
        top = raw.amax(dim=(1, 2), keepdim=True)
        return (torch.maximum(raw, top - cfg.dynamic_range_db_factor) + 4.0) / 4.0

    mel_err, mel = 0.0, {}
    for B, chunks in ((1, 20), (4, 20), (32, 20), (4, 480)):
        x = torch.from_numpy(np.stack([speech(chunks * CHUNK_SAMPLES / SR, seed=90 + i)
                                       * (0.05 + 0.03 * i) for i in range(B)])).cuda()
        padded = F.pad(x[:, None], (200, 200), mode="reflect")[:, 0]
        nf = chunks * CHUNK_SAMPLES // cfg.hop_length
        before = _build.launch_counts["log_mel"]
        raw = log_mel_frames_cuda(padded, basis, fb, nf, cfg.hop_length)
        check(_build.launch_counts["log_mel"] - before == 1,
              f"log_mel B={B}: {_build.launch_counts['log_mel'] - before} launches")
        err = (normalized(raw) - normalized(log_mel_frames_plain(padded, basis, fb, nf,
                                                                 cfg.hop_length))
               ).abs().max().item()
        check(raw.shape == (B, nf, cfg.n_mels) and np.isfinite(err) and err <= MEL_TOL,
              f"log_mel B={B} x {nf} frames: max err {err} > {MEL_TOL}")
        mel_err = max(mel_err, err)
        if B == 32:
            window = torch.hann_window(cfg.n_fft, periodic=True, device="cuda")

            def library():
                spec = torch.stft(x, cfg.n_fft, cfg.hop_length, window=window, center=True,
                                  pad_mode="reflect", return_complex=True)[:, :, :nf]
                return torch.log10(torch.clamp(spec.abs().transpose(1, 2) ** 2 @ fb, min=1e-10))

            ms = timer.ms(lambda: log_mel_frames_cuda(padded, basis, fb, nf, cfg.hop_length))
            plain_ms = timer.ms(lambda: log_mel_frames_plain(padded, basis, fb, nf,
                                                             cfg.hop_length))
            lib_ms = timer.ms(library)
            n_bins = cfg.n_freq_bins
            n_bytes = 4 * (padded.numel() + basis.numel() + fb.numel() + B * nf * cfg.n_mels)
            flops = B * nf * (2 * cfg.n_fft * 2 * n_bins + 3 * n_bins + 2 * n_bins * cfg.n_mels)
            b_ms, b_by = min(bound_ms(n_bytes, flops),
                             bound_ms(n_bytes, 3 * flops, TF32_FLOPS_PER_S))
            log(f"log_mel batched B={B} x {nf} frames (one launch): kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, stft+matmul {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
            mel = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"log_mel batched: max abs err {mel_err:.3g} <= {MEL_TOL} at B 1, 4, 32 x 128 frames "
        f"and B 4 x 3072 frames, one launch each")
    out["log_mel"] = dict(max_abs_err=mel_err, B32=mel)

    # ---- the int8 decode kernels at the batcher's rows ----
    shapes = {"qkv": (dec.d_model, (nh + 2 * nkv) * hd), "o": (nh * hd, dec.d_model),
              "gate_up": (dec.d_model, 2 * dec.ffn_hidden), "down": (dec.ffn_hidden, dec.d_model)}
    w16_err, w8a8_rows = 0.0, []
    for p, (K, N) in shapes.items():
        qt = quantize_tensor(torch.randn((2, K, N), generator=gen, device="cuda") * 0.02)
        q, sc = qt["q"], qt["scale"]
        for B in (4, 16, 33, 65):
            x = torch.randn((B, K), generator=gen, device="cuda").to(torch.bfloat16)
            if B >= 16:
                before = _build.launch_counts["int8_matmul_mma"]
                got = im.int8_matmul_stacked_cuda(x, q, sc, 1)
                check(_build.launch_counts["int8_matmul_mma"] - before == 1,
                      f"int8_matmul_stacked {p} B={B}: not on the tensor cores")
                w16_err = max(w16_err, check_w16(torch, "int8_matmul_stacked", got,
                                                 im.int8_matmul_stacked_plain(x, q, sc, 1),
                                                 f"{p} B={B}"))
            got = im.int8_matmul_w8a8_cuda(x, q, sc, 1)
            want = im.int8_matmul_w8a8_plain(x.cpu(), q.cpu(), sc.cpu(), 1).cuda()
            check(torch.equal(got, want), f"int8_matmul_w8a8 {p} B={B}: differs from the recipe")
            w8a8_rows.append(B)
    log(f"int8 at the batcher's rows: stacked W8A16 (tensor cores) B 16, 33, 65 max abs err "
        f"{w16_err:.3g}; W8A8 B 4, 16, 33, 65 equal to the recipe (qkv/o/gate_up/down)")
    out["int8_matmul_stacked"] = dict(max_abs_err=w16_err, rows=[16, 33, 65])
    out["int8_matmul_w8a8"] = dict(max_abs_err=0.0, rows=sorted(set(w8a8_rows)))
    return out


def first_divergence(got: list, want: list, names=("batched", "threaded")) -> str:
    """Where two lists of per-segment tokens first differ: (segment, step,
    both tokens, named `names`), or 'equal'."""
    if len(got) != len(want):
        return f"{len(got)} segments vs {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        n = min(len(g), len(w))
        diff = np.flatnonzero(np.asarray(g[:n]) != np.asarray(w[:n]))
        if len(diff) or len(g) != len(w):
            step = int(diff[0]) if len(diff) else n
            tg = int(g[step]) if step < len(g) else "end"
            tw = int(w[step]) if step < len(w) else "end"
            return f"segment {i} step {step}: {names[0]} {tg}, {names[1]} {tw}"
    return "equal"


def batched_files(torch, engine, vad, mode: str) -> dict:
    """The 3 s, 12 s and 35 s WAVs submitted at once through the file path
    (transcribe_file_stream) on the batched engine, launch counters set to
    0 just before and read just after: each request's wall and RTF,
    aggregate decode tokens/s and peak memory; log_mel once per prepared
    host request and decode attention once per layer per decode step of
    each pool; tokens beside the threaded engine's (captured in phase 3 on
    the same weights; the first divergence printed, not checked)."""
    from sonicscribe_tpu_torch.audio.wav import write_wav
    from sonicscribe_tpu_torch.config import AppConfig
    from sonicscribe_tpu_torch.ops import _build
    from sonicscribe_tpu_torch.serve.decode import decode_audio
    from sonicscribe_tpu_torch.serve.files import FileTranscriptionConfig, transcribe_file_stream

    config = AppConfig()
    n_layers = engine.transcriber.cfg.decoder.n_layers
    decoded = {name: decode_audio(write_wav(a, SR), f"{name}.wav", engine.transcriber.device)
               for name, a in payloads().items()}
    torch.cuda.synchronize()
    recs = {name: Recording(engine) for name in decoded}

    async def one(name):
        file_cfg = FileTranscriptionConfig.from_dict(
            {}, default_threshold=config.vad_speech_threshold)
        file_cfg.max_new_tokens = config.file_max_new_tokens
        file_cfg.concurrency = engine.concurrency_hint
        t0 = time.perf_counter()
        msgs = await _collect(transcribe_file_stream(decoded[name], recs[name], vad, file_cfg,
                                                     f"{name}.wav"))
        return name, msgs, time.perf_counter() - t0

    async def all_at_once():
        return await asyncio.gather(*[one(name) for name in decoded])

    stats0 = dict(engine.stats)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    done = asyncio.run(all_at_once())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    delta = {k: engine.stats[k] - stats0.get(k, 0) for k in
             ("decode_steps", "verify_rounds", "tokens", "requests", "mel_preps",
              "prefill_programs")}
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = dict(wall_s=wall, peak_gib=peak, tokens=delta["tokens"],
               tokens_per_s=delta["tokens"] / wall, decode_steps=delta["decode_steps"],
               prefill_programs=delta["prefill_programs"], requests={},
               launches={k: v for k, v in counts.items() if v})
    for name, msgs, req_wall in done:
        n_seg = msgs[0]["total_segments"]
        check([m["type"] for m in msgs] == ["initialization", "segments_summary"]
              + ["segment_result"] * n_seg + ["final_summary"],
              f"batched {mode} {name}: NDJSON {[m['type'] for m in msgs]}")
        tokens = [c["tokens"] for c in recs[name].calls]
        threaded = THREADED_TOKENS.get((mode, name))
        div = first_divergence(tokens, threaded) if threaded is not None else "not run"
        out["requests"][name] = dict(wall_s=req_wall, rtf=req_wall * SR / len(decoded[name]),
                                     segments=n_seg, vs_threaded=div)
        log(f"batched {mode} {name}: {n_seg} segments, wall {req_wall:.3f} s, RTF "
            f"{out['requests'][name]['rtf']:.4f}; tokens vs the threaded engine: {div}")
    check(delta["requests"] == sum(len(r.calls) for r in recs.values()),
          f"batched {mode} files: {delta['requests']} finished for "
          f"{sum(len(r.calls) for r in recs.values())} segments")
    check(counts["log_mel"] == delta["mel_preps"] > 0,
          f"batched {mode} files: log_mel launched {counts['log_mel']} times for "
          f"{delta['mel_preps']} prepared requests")
    check(delta["verify_rounds"] == 0, f"batched {mode} files: undrafted requests took "
          f"{delta['verify_rounds']} verify rounds")
    check(counts["decode_attention"] == n_layers * delta["decode_steps"] > 0,
          f"batched {mode} files: decode_attention launched {counts['decode_attention']} times "
          f"for {delta['decode_steps']} pool decode steps x {n_layers} layers")
    log(f"batched {mode} files at once: wall {wall:.3f} s, {delta['tokens']} tokens, "
        f"{out['tokens_per_s']:.1f} tokens/s, {delta['decode_steps']} pool decode steps, "
        f"{delta['prefill_programs']} prefill programs, peak {peak:.2f} GiB, launches "
        f"{out['launches']}")
    return out


def batched_streams(torch, engine, vad, mode: str) -> dict:
    """BATCHED_STREAMS StreamSessions on the ring, each a real-time stream
    of STREAM_SPANS (its own seed) starting STREAM_STAGGER_S after the one
    before, while the 12 s file request is served; launch counters set to 0
    just before and read just after. Checks: each session's committed
    segments and parts are the ones the gate implies on window_probs of its
    samples; no graph captured; no call failed; log_mel once per ring
    prefill program and prepared host request; decode attention once per
    layer per pool decode step. -> tentative delay p50/p95, speech end ->
    committed p50/max, interims sent and dropped, the ring VAD program's
    device time, launch counts."""
    from sonicscribe_tpu_torch.audio.wav import write_wav
    from sonicscribe_tpu_torch.config import AppConfig
    from sonicscribe_tpu_torch.ops import _build
    from sonicscribe_tpu_torch.serve.decode import decode_audio
    from sonicscribe_tpu_torch.serve.files import FileTranscriptionConfig, transcribe_file_stream
    from sonicscribe_tpu_torch.serve.session import StreamSession
    from sonicscribe_tpu_torch.vad.model import WINDOW_SAMPLES, window_probs

    config = AppConfig()
    n_layers = engine.transcriber.cfg.decoder.n_layers
    w = config.vad_process_window
    streams = []
    for i in range(BATCHED_STREAMS):
        frames, samples, ends = stream_frames(STREAM_SPANS, seed=40 + 10 * i)
        n_win, per = len(frames) // w, w * CHUNK_SAMPLES // WINDOW_SAMPLES
        sub = window_probs(vad, samples)[: n_win * per].reshape(n_win, per)
        streams.append(dict(frames=frames, ends=ends, want=gate_commits(sub.max(axis=1), config),
                            msgs=[], arrivals=[], sent=[], attempts=[0]))
    wav = decode_audio(write_wav(payloads()["12s"], SR), "12s.wav", engine.transcriber.device)
    torch.cuda.synchronize()
    errors = ErrorCount()
    session_log = logging.getLogger("sonicscribe_tpu_torch.serve.session")

    async def feed(i, st, t0):
        async def send(m):
            st["msgs"].append(m)
            st["arrivals"].append(time.perf_counter())

        session = StreamSession(f"s{i}", config, engine, send)
        run_interim = session._run_interim

        async def counted(*a):
            st["attempts"][0] += 1
            await run_interim(*a)

        session._run_interim = counted
        start = t0 + i * STREAM_STAGGER_S
        for j, frame in enumerate(st["frames"]):
            await asyncio.sleep(max(0.0, start + j * 0.064 - time.perf_counter()))
            st["sent"].append(time.perf_counter())
            await session.on_audio(frame)
        for _ in range(1200):  # the last final: at most 60 s more
            if sum(m["type"] == "committed_output" for m in st["msgs"]) >= len(st["want"]):
                break
            await asyncio.sleep(0.05)
        await session.flush()
        await session.cleanup()

    async def run():
        t0 = time.perf_counter()
        file_cfg = FileTranscriptionConfig.from_dict(
            {}, default_threshold=config.vad_speech_threshold)
        file_cfg.concurrency = engine.concurrency_hint
        file_task = asyncio.ensure_future(_collect(transcribe_file_stream(
            wav, engine, vad, file_cfg, "12s.wav")))
        await asyncio.gather(*[feed(i, st, t0) for i, st in enumerate(streams)])
        file_msgs = await file_task
        return time.perf_counter() - t0, file_msgs

    graphs0 = engine.router.stats["graphs"]
    stats0 = dict(engine.stats)
    engine.spans.clear()
    session_log.addHandler(errors)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    try:
        wall, file_msgs = asyncio.run(run())
        torch.cuda.synchronize()
    finally:
        session_log.removeHandler(errors)
    counts = dict(_build.launch_counts)
    captured = engine.router.stats["graphs"] - graphs0
    delta = {k: engine.stats[k] - stats0.get(k, 0) for k in
             ("decode_steps", "verify_rounds", "mel_preps", "ring_prefill_programs",
              "prefill_programs", "vad_batches", "requests", "eager_granted", "eager_denied")}
    check(not errors.records, f"batched {mode} streams: {len(errors.records)} failed calls")
    check(captured == 0, f"batched {mode} streams: {captured} graphs captured during the run")
    check(file_msgs[-1]["type"] == "final_summary" and file_msgs[-1]["failed_segments"] == 0,
          f"batched {mode} streams: the 12 s file request ended {file_msgs[-1]}")
    delays, end_to_commit, sent_n, dropped = [], [], 0, 0
    for i, st in enumerate(streams):
        committed = [m for m in st["msgs"] if m["type"] == "committed_output"]
        tentative = [m for m in st["msgs"] if m["type"] == "tentative_output"]
        got = [(m["segment_id"], m["start_chunk_id"], m["end_chunk_id"]) for m in committed]
        want = [(c["segment_id"], c["start"], c["end"]) for c in st["want"]]
        check(got == want, f"batched {mode} stream {i}: committed {got}, the gate implies {want}")
        delays += [m["processing_delay"] for m in tentative]
        for m in committed:
            c = next(c for c in st["want"] if c["segment_id"] == m["segment_id"])
            end = next(e for e in st["ends"] if e >= c["start"])
            end_to_commit.append(st["arrivals"][st["msgs"].index(m)] - st["sent"][end])
        sent_n += len(tentative)
        dropped += st["attempts"][0] - len(tentative)
    check(counts["log_mel"] == delta["ring_prefill_programs"] + delta["mel_preps"],
          f"batched {mode} streams: log_mel launched {counts['log_mel']} times for "
          f"{delta['ring_prefill_programs']} ring prefill programs + {delta['mel_preps']} host "
          f"requests")
    plain_steps = delta["decode_steps"] - delta["verify_rounds"]
    check(counts["decode_attention"] == n_layers * plain_steps > 0,
          f"batched {mode} streams: decode_attention launched {counts['decode_attention']} "
          f"times for {plain_steps} plain pool decode steps x {n_layers} layers")
    check(counts["verify_attention"] == n_layers * delta["verify_rounds"],
          f"batched {mode} streams: verify_attention launched {counts['verify_attention']} "
          f"times for {delta['verify_rounds']} verify rounds x {n_layers} layers")
    check(counts["verify_attention_mma"] == counts["verify_attention"],
          f"batched {mode} streams: {counts['verify_attention_mma']} of "
          f"{counts['verify_attention']} bf16 verify launches on the tensor cores")

    # the ring VAD program of this run's batch bucket, replayed alone
    B = next(b for b in (1, 4, 16, 64) if b >= BATCHED_STREAMS)
    key, fn, bufs = engine._vad_ring_entry(B)
    times = []
    for _ in range(20):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        engine.router.run(key, fn, bufs)
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    vad_ms = float(np.median([a.elapsed_time(b) for a, b in times]))

    def pct(xs, q):
        return float(np.percentile(xs, q)) if len(xs) else None

    out = dict(sessions=BATCHED_STREAMS, stagger_s=STREAM_STAGGER_S, wall_s=wall,
               graphs_captured=captured, interims_sent=sent_n, interims_dropped=dropped,
               tentative_delay_p50_s=pct(delays, 50), tentative_delay_p95_s=pct(delays, 95),
               speech_end_to_committed_p50_s=pct(end_to_commit, 50),
               speech_end_to_committed_max_s=max(end_to_commit),
               vad_ring_ms=vad_ms, vad_ring_batch=B, peak_gib=torch.cuda.max_memory_allocated()
               / 2**30, file_rtf=file_msgs[-1]["rtf"], engine=delta,
               eager_accept_ema=engine.eager_accept_ema, spec_accept_ema=engine.spec_accept_ema,
               spec_accept_min=engine.spec_accept_min,
               launches={k: v for k, v in counts.items() if v})
    log(f"batched {mode} streams: {BATCHED_STREAMS} sessions + the 12 s file in {wall:.2f} s, "
        f"committed as the gate implies, 0 graphs captured; {sent_n} interims sent, {dropped} "
        f"dropped; tentative delay p50 {out['tentative_delay_p50_s']:.3f} s p95 "
        f"{out['tentative_delay_p95_s']:.3f} s; speech end -> committed p50 "
        f"{out['speech_end_to_committed_p50_s']:.3f} s max "
        f"{out['speech_end_to_committed_max_s']:.3f} s; ring VAD program (B={B}) "
        f"{vad_ms:.4f} ms; file RTF {out['file_rtf']}; {delta}")
    out["tick_phases"] = tick_split(engine)
    log(f"batched {mode} streams, tick phases (host ms, p50 / p95 of "
        f"{out['tick_phases']['ticks']} ticks, {out['tick_phases']['ticks_lost']} lost): "
        + ", ".join(f"{k} {v[0]:.3f} / {v[1]:.3f}" for k, v in out["tick_phases"].items()
                    if k not in ("ticks", "ticks_lost")))
    log(f"batched {mode} streams, speculation: {delta['eager_granted']} eager finals launched, "
        f"{delta['eager_denied']} gated, eager_accept_ema {engine.eager_accept_ema:.3f}; "
        f"{delta['verify_rounds']} verify rounds; spec_accept_ema {engine.spec_accept_ema:.3f} "
        f"(drafts spent while >= {engine.spec_accept_min}: random weights' interims are no "
        f"draft of their finals)")
    return out


def batched_drafts(torch, engine, mode: str, fast_boot_tokens=None) -> dict:
    """The 12 s file's request on the batched engine (one request, the
    file budget): undrafted first, its greedy tokens the drafts'
    source; then with each of draft_kinds (golden, half then garbage,
    garbage). Launch counters set to 0 just before the drafted runs and
    read just after: verify_attention once per layer per verify round,
    decode_attention once per layer per plain step, no graph captured
    (every verify key of the grid was captured by warmup), the golden run
    on verify rounds. Per run: wall, tokens/s, verify rounds,
    spec_accept_ema after it, and the first divergence from the undrafted
    tokens (the verify program has other shapes than the decode program,
    so bf16 near-ties may flip: printed, not checked, with the two tokens'
    logits there from tie_logits). fast_boot_tokens: the same request's
    tokens served before a fast boot's deferred keys landed (full rows, k
    <= 8), whose first divergence from the undrafted run is printed: bf16
    near-ties part program shapes, so it is not checked."""
    from sonicscribe_tpu_torch.ops import _build

    audio = payloads()["12s"]
    n_layers = engine.transcriber.cfg.decoder.n_layers

    def run(draft):
        stats0 = dict(engine.stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = asyncio.run(engine.transcribe(audio, SR, max_new_tokens=GRID_BUDGETS[-1],
                                          draft_tokens=draft))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d = {k: engine.stats[k] - stats0.get(k, 0) for k in
             ("decode_steps", "verify_rounds", "tokens")}
        return r.tokens, dict(wall_s=wall, tokens=d["tokens"], tokens_per_s=d["tokens"] / wall,
                              decode_steps=d["decode_steps"], verify_rounds=d["verify_rounds"],
                              spec_accept_ema=engine.spec_accept_ema)

    base, row = run(None)
    check(row["verify_rounds"] == 0, f"batched {mode}: an undrafted request took verify rounds")
    out = {"undrafted": row}
    log(f"batched {mode} 12 s request undrafted: wall {row['wall_s']:.3f} s, {row['tokens']} "
        f"tokens, {row['tokens_per_s']:.1f} tokens/s, {row['decode_steps']} pool decode steps")
    if fast_boot_tokens is not None:
        row["fast_boot_vs_undrafted"] = first_divergence([fast_boot_tokens], [base],
                                                         ("before the drain", "after"))
        log(f"batched {mode} 12 s request served before the fast boot's deferred keys landed, "
            f"against the same request after: {row['fast_boot_vs_undrafted']}")
    graphs0 = engine.router.stats["graphs"]
    stats0 = dict(engine.stats)
    drafted = {}
    _build.reset_launch_counts()
    for name, draft in draft_kinds(base, engine.cfg.decoder.vocab_size).items():
        tokens, row = run(draft)
        drafted[name] = tokens
        row["vs_undrafted"] = first_divergence([tokens], [base], ("drafted", "undrafted"))
        out[name] = row
        log(f"batched {mode} 12 s request, {name} draft: wall {row['wall_s']:.3f} s, "
            f"{row['tokens']} tokens, {row['tokens_per_s']:.1f} tokens/s, {row['verify_rounds']} "
            f"verify rounds in {row['decode_steps']} pool steps, spec_accept_ema "
            f"{row['spec_accept_ema']:.3f}; tokens vs undrafted: {row['vs_undrafted']}")
    counts = dict(_build.launch_counts)
    rounds = engine.stats["verify_rounds"] - stats0["verify_rounds"]
    steps = engine.stats["decode_steps"] - stats0["decode_steps"]
    captured = engine.router.stats["graphs"] - graphs0
    check(out["golden"]["verify_rounds"] > 0, f"batched {mode}: the golden draft took no verify "
          "round")
    check(captured == 0, f"batched {mode} drafts: {captured} graphs captured on the request path")
    check(counts["verify_attention"] == n_layers * rounds > 0,
          f"batched {mode} drafts: verify_attention launched {counts['verify_attention']} times "
          f"for {rounds} verify rounds x {n_layers} layers")
    check(counts["verify_attention_mma"] == counts["verify_attention"],
          f"batched {mode} drafts: {counts['verify_attention_mma']} of "
          f"{counts['verify_attention']} bf16 verify launches on the tensor cores")
    check(counts["decode_attention"] == n_layers * (steps - rounds),
          f"batched {mode} drafts: decode_attention launched {counts['decode_attention']} times "
          f"for {steps - rounds} plain steps x {n_layers} layers")
    out["launches"] = {k: v for k, v in counts.items() if v}
    log(f"batched {mode} drafts: {rounds} verify rounds, {steps - rounds} plain steps, 0 graphs "
        f"captured, launches {out['launches']}")
    for name, tokens in drafted.items():  # after the counts: these launches are not the path's
        step = first_step_differing(tokens, base)
        if step:  # step 0 is prefill's pick, the same program drafted or not
            out["tie"] = dict(draft=name, **tie_logits(torch, engine, audio, base, tokens, step))
            t = out["tie"]
            log(f"batched {mode} {name} draft, first divergence at step {step}: logits "
                f"recomputed op by op at S 1 from the undrafted prefix (logit of undrafted "
                f"{t['undrafted']} - logit of drafted {t['drafted']}): decode step "
                f"{t['decode_margin']:+.4f} (logits {t['decode_logits'][0]:.4f}, "
                f"{t['decode_logits'][1]:.4f}; top logit {t['decode_top']:.4f}); verify pass, "
                f"the step at query 0..{len(t['verify_margins']) - 1}: "
                + ", ".join(f"{m:+.4f}" for m in t["verify_margins"]))
            break
    return out


def first_step_differing(got, want):
    """The first step at which two token lists differ, both holding a
    token there; None where they are equal or differ only in length."""
    n = min(len(got), len(want))
    diff = np.flatnonzero(np.asarray(got[:n]) != np.asarray(want[:n]))
    return int(diff[0]) if len(diff) else None


def tie_logits(torch, engine, audio, base, drafted, step: int) -> dict:
    """The logits of the two tokens at a drafted run's first divergence
    from the undrafted one, recomputed op by op at S 1 from the engine's
    own prompt (its request prep, assemble_prompt_batch, prefill_kv) with
    the undrafted tokens fed: by decode_step at the step, and by
    verify_step with the step at each query position j (its round started
    j tokens earlier, the undrafted tokens as the draft). A near-tie shows
    margins near 0, of either sign; a fault in the numbers, a large one."""
    from types import SimpleNamespace

    from sonicscribe_tpu_torch.engine.batcher import assemble_prompt_batch
    from sonicscribe_tpu_torch.models.glm_asr import (
        decode_step,
        init_cache,
        prefill_kv,
        verify_step,
    )

    tr, w = engine.transcriber, engine.spec_w
    params, cfg, dev = tr.params, tr.cfg, engine.long.state["k"].device
    a, b = int(base[step]), int(drafted[step])
    req = SimpleNamespace(audio=audio, sample_rate=SR, hotwords=None, future=None)
    bucket, mel, frames, prefix, suffix, slen, _ = engine._prepare_request(req)
    ids = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=dev)  # noqa: E731
    tokens = ids(np.concatenate([base, np.full(w + 1, base[-1])]))
    with torch.inference_mode():
        buf, totals = assemble_prompt_batch(
            params, cfg, mel[None], ids([frames]).int(), ids(prefix), ids(suffix)[None],
            ids([slen]).int())
        ks, vs, _ = prefill_kv(params, cfg, buf, totals)
        cache = init_cache(cfg, 1, engine.long.max_len, dtype=engine.long.state["k"].dtype,
                           device=dev)
        cache["k"][:, :, : ks.shape[2]] = ks.to(cache["k"].dtype)
        cache["v"][:, :, : vs.shape[2]] = vs.to(cache["v"].dtype)
        cache["len"].copy_(totals.to(torch.int32))
        verify_margins = [0.0] * (w + 1)
        for i in range(1, step + 1):  # step i feeds token i - 1 and picks token i
            j = step - i  # a round starting here holds the step at query j
            if j <= w:
                fork = {k: v.clone() for k, v in cache.items()}
                _, vl = verify_step(params, cfg, fork, tokens[i - 1 : i + w][None])
                verify_margins[j] = float(vl[0, j, a] - vl[0, j, b])
                del fork
            _, logits = decode_step(params, cfg, cache, tokens[i - 1 : i])
        top = float(logits[0].max())
        la, lb = float(logits[0, a]), float(logits[0, b])
    return dict(step=step, undrafted=a, drafted=b, decode_logits=(la, lb),
                decode_margin=la - lb, decode_top=top, verify_margins=verify_margins)


def batched_ticks(torch, engine) -> dict:
    """Decode at 1, 4, 16 and 32 active long slots: n concurrent 3 s
    requests at a TICK_BUDGET-token budget (the random weights run to the
    budget), once for the wall and tokens/s, and at the TICK_PROFILED counts
    once more under torch.profiler for the device busy time and idle share
    of the run."""
    from torch.autograd import DeviceType

    audio = payloads()["3s"]

    async def run(n):
        rs = await asyncio.gather(*[engine.transcribe(audio, SR, max_new_tokens=TICK_BUDGET)
                                    for _ in range(n)])
        return sum(len(r.tokens) for r in rs)

    out = {}
    for n in TICK_SLOTS:
        tokens0, steps0 = engine.stats["tokens"], engine.stats["decode_steps"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        asyncio.run(run(n))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = engine.stats["tokens"] - tokens0
        steps = engine.stats["decode_steps"] - steps0
        out[str(n)] = dict(wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
                           decode_steps=steps)
        line = (f"batched decode, {n} active long slots x {TICK_BUDGET} tokens: wall "
                f"{wall:.3f} s, {tokens} tokens, {tokens / wall:.1f} tokens/s, {steps} pool "
                f"decode steps")
        if n not in TICK_PROFILED:
            log(line)
            continue

        def timed():
            t1 = time.perf_counter()
            asyncio.run(run(n))
            torch.cuda.synchronize()
            return time.perf_counter() - t1

        prof, pwall = profiled(torch, timed)
        busy = sum(dev_us(e) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3
        check(busy > 0, f"batched decode at {n} slots: the profiler saw no device time")
        out[str(n)].update(profiled_wall_s=pwall, busy_ms=busy,
                           idle=max(0.0, 1 - busy / (pwall * 1e3)))
        log(f"{line}; profiled: wall {pwall:.3f} s, device busy {busy:.1f} ms, idle share "
            f"{out[str(n)]['idle']:.3f}")
    return out


def registered_grid(engine) -> dict:
    """The programs dispatch may use, by pool and kind."""
    return {p.name: {"host": set(p.compiled_prefill), "ring": set(p.compiled_ring_prefill),
                     "decode": set(p.compiled_decode), "verify": set(p.compiled_verify)}
            for p in engine.pools}


def expected_grid(engine, full: bool = False) -> dict:
    """The grid (engine._grid(full)) in registered_grid's form."""
    out = {p.name: {"host": set(), "ring": set(), "decode": set(), "verify": set()}
           for p in engine.pools}
    for kind, cells in engine._grid(full=full).items():
        for pool, *rest in cells:
            out[pool.name][kind].add(tuple(rest))
    return out


def fast_boot(torch, engine, mode: str) -> dict:
    """warmup(fast=True): the blocking seconds, graphs and peak memory; the
    12 s request served first, while the deferred keys wait (full rows, k
    <= 8, B = 1 groups: nothing captured on its path; idle ticks may
    capture deferred keys after it); then warmup_join() and
    drain_replays() (seconds, graphs, the peak memory during them), no
    capture failed, and the registered grid _grid()'s. -> numbers, and the
    request's tokens under "tokens"."""
    rs = engine.router.stats
    torch.cuda.synchronize()
    w = engine.warmup(budgets=GRID_BUDGETS, fast=True)
    torch.cuda.synchronize()
    out = dict(blocking_s=w["seconds"], graphs=w["graphs"], deferred=w["deferred"],
               max_gib=torch.cuda.max_memory_allocated() / 2**30,
               resident_gib=torch.cuda.memory_allocated() / 2**30,
               phases=dict(engine.stats["warmup_phase_s"]))
    log(f"batched {mode} fast boot: {w['graphs']} graphs captured in {w['seconds']:.1f} s "
        f"(blocking; phases {out['phases']}), {w['deferred']} keys deferred; max "
        f"{out['max_gib']:.2f} GiB, resident {out['resident_gib']:.2f} GiB")
    graphs0, on_run0, keys0 = rs["graphs"], rs["captured_on_run"], set(rs["capture_s"])
    stats0 = dict(engine.stats)
    t0 = time.perf_counter()
    r = asyncio.run(engine.transcribe(payloads()["12s"], SR, max_new_tokens=GRID_BUDGETS[-1]))
    torch.cuda.synchronize()
    out["first_request"] = dict(
        wall_s=time.perf_counter() - t0, tokens=len(r.tokens),
        decode_steps=engine.stats["decode_steps"] - stats0["decode_steps"],
        idle_captures=rs["graphs"] - graphs0)
    check(rs["captured_on_run"] == on_run0, f"batched {mode} fast boot: the first request "
          f"captured {rs['captured_on_run'] - on_run0} graphs on its path")
    log(f"batched {mode} fast boot, the 12 s request first: wall "
        f"{out['first_request']['wall_s']:.3f} s, {len(r.tokens)} tokens, "
        f"{out['first_request']['decode_steps']} pool decode steps, 0 graphs captured on its "
        f"path, {out['first_request']['idle_captures']} deferred keys captured in idle ticks")
    torch.cuda.reset_peak_memory_stats()
    graphs1 = rs["graphs"]
    t1 = time.perf_counter()
    engine.warmup_join()
    join_s = time.perf_counter() - t1
    drain_s = engine.drain_replays()
    torch.cuda.synchronize()
    out.update(join_s=join_s, drain_s=drain_s, drain_graphs=rs["graphs"] - graphs1,
               drain_max_gib=torch.cuda.max_memory_allocated() / 2**30,
               graphs_total=rs["graphs"],
               deferred_s=engine.stats["warmup_phase_s"].get("deferred", 0.0),
               capture_failures=engine.stats["warmup_capture_failures"], tokens=r.tokens)
    # the slowest deferred capture (on the card every deferred key is captured by now)
    slowest = max((k for k in rs["capture_s"] if k not in keys0), key=rs["capture_s"].get,
                  default=None)
    out["slowest_deferred"] = dict(key=str(slowest), capture_s=rs["capture_s"].get(slowest),
                                   warm_s=rs["warm_s"].get(slowest))
    check(engine.stats["warmup_capture_failures"] == 0,
          f"batched {mode} fast boot: {engine.stats['warmup_capture_failures']} deferred "
          "captures failed")
    check(engine.stats["warmup_background_pending"] == 0 and not engine._replay_queue,
          f"batched {mode} fast boot: {engine.stats['warmup_background_pending']} deferred keys "
          "left after the drain")
    log(f"batched {mode} fast boot drained: warmup_join {join_s:.2f} s, drain_replays "
        f"{drain_s:.2f} s, {out['drain_graphs']} graphs ({out['graphs_total']} in all; deferred "
        f"captures {out['deferred_s']:.2f} s in all; the slowest {out['slowest_deferred']}), "
        f"max {out['drain_max_gib']:.2f} GiB during them, warmup_capture_failures 0")
    return out


def tick_split(engine) -> dict:
    """p50 and p95 of each tick phase and admit detail (host ms) of the
    ticks in the engine's span ring, and the ticks that fell off it."""
    from sonicscribe_tpu_torch.engine.spans import tick_phases

    ticks = tick_phases(engine.spans.records())
    phases = ("ingest_ms", "vad_dispatch_ms", "admit_ms", "early_resolve_ms",
              "decode_dispatch_ms", "resolve_ms", "sync_ms", "total_ms")
    detail = ("prep_ms", "write_ms", "dispatch_ms", "groups_short", "groups_long")
    out: dict = {"ticks": len(ticks), "ticks_lost": engine.spans.lost}
    for name, rows in [(k, [t[k] for t in ticks]) for k in phases] + [
            ("admit_" + k, [t["admit_detail"][k] for t in ticks]) for k in detail]:
        out[name] = (float(np.percentile(rows, 50)), float(np.percentile(rows, 95))) if rows \
            else (0.0, 0.0)
    return out


DUAL_SHORTS = 16  # interim-budget requests beside the three files in the dual A/B


def dual_ab(torch, engine, vad) -> dict:
    """The fused dual decode, A/B on one native engine (built with
    fuse_dual_decode; engine.fuse_dual toggled): the three files through
    the file path and DUAL_SHORTS interim-budget host requests (1 s each,
    the short pool) at once as soon as a file segment holds a long slot,
    unfused then fused, then each once more under torch.profiler with the
    3 s file alone (at PROFILE_BUDGET tokens) beside the shorts. Per run: walls, aggregate tokens/s, dual decodes (> 0
    fused, 0 unfused), pool decode steps, decode attention once per layer
    per pool step (two launches a dual step: one per pool), nothing
    captured on the path; per profiled run the device busy per pool step.
    Each request's first divergence fused vs unfused is printed (bf16
    near-ties part program shapes), not checked. -> numbers and the
    timed runs' launch counts ("launches": two dicts)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sonicscribe_tpu_torch.audio.wav import write_wav
    from sonicscribe_tpu_torch.config import AppConfig
    from sonicscribe_tpu_torch.ops import _build
    from sonicscribe_tpu_torch.serve.decode import decode_audio
    from sonicscribe_tpu_torch.serve.files import FileTranscriptionConfig, transcribe_file_stream

    config = AppConfig()
    n_layers = engine.transcriber.cfg.decoder.n_layers
    decoded = {name: decode_audio(write_wav(a, SR), f"{name}.wav", engine.transcriber.device)
               for name, a in payloads().items()}
    shorts = [speech(1.0, seed=60 + i) for i in range(DUAL_SHORTS)]
    torch.cuda.synchronize()

    async def run_all(names, file_budget):
        recs = {name: Recording(engine) for name in names}

        async def one(name):
            file_cfg = FileTranscriptionConfig.from_dict(
                {}, default_threshold=config.vad_speech_threshold)
            file_cfg.max_new_tokens = file_budget
            file_cfg.concurrency = engine.concurrency_hint
            t0 = time.perf_counter()
            await _collect(transcribe_file_stream(decoded[name], recs[name], vad, file_cfg,
                                                  f"{name}.wav"))
            return time.perf_counter() - t0

        async def short(a):
            # sent once a file segment holds a long slot, so that both pools
            # are active (the files' host prep comes first)
            while not engine.long.n_active:
                await asyncio.sleep(0.001)
            t0 = time.perf_counter()
            r = await engine.transcribe(a, SR, max_new_tokens=config.interim_max_new_tokens)
            return r.tokens, time.perf_counter() - t0

        got = await asyncio.gather(*[one(n) for n in names], *[short(a) for a in shorts])
        walls = dict(zip(names, got[: len(names)]))
        tokens = {n: [c["tokens"] for c in recs[n].calls] for n in names}
        tokens["shorts"] = [t for t, _ in got[len(names):]]
        walls["shorts_max"] = max(w for _, w in got[len(names):])
        return walls, tokens

    def run(fused: bool, profiled: bool, tries: int = 1):
        engine.fuse_dual = fused
        stats0, on_run0 = dict(engine.stats), engine.router.stats["captured_on_run"]
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profiled:  # reading a profile's records costs time by their number
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                walls, tokens = asyncio.run(run_all(("3s",), PROFILE_BUDGET))
                torch.cuda.synchronize()
        else:
            walls, tokens = asyncio.run(run_all(tuple(decoded), config.file_max_new_tokens))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.launch_counts)
        d = {k: engine.stats[k] - stats0.get(k, 0) for k in
             ("decode_steps", "dual_decodes", "tokens", "requests", "verify_rounds")}
        label = "fused" if fused else "unfused"
        check(engine.router.stats["captured_on_run"] == on_run0,
              f"dual A/B {label}: graphs captured on the request path")
        check((d["dual_decodes"] > 0) == fused,
              f"dual A/B {label}: {d['dual_decodes']} dual decodes")
        plain = d["decode_steps"] - d["verify_rounds"]
        check(counts["decode_attention"] == n_layers * plain > 0,
              f"dual A/B {label}: decode_attention launched {counts['decode_attention']} times "
              f"for {plain} plain pool steps x {n_layers} layers")
        row = dict(wall_s=wall, walls=walls, tokens=d["tokens"], tokens_per_s=d["tokens"] / wall,
                   decode_steps=d["decode_steps"], dual_decodes=d["dual_decodes"],
                   verify_rounds=d["verify_rounds"], requests=d["requests"])
        if profiled:
            busy = sum(dev_us(e) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA) / 1e3
            if busy == 0 and tries < PROFILE_TRIES:  # the profile lost its records
                log(f"dual A/B {label}: an empty profile; running it again")
                return run(fused, True, tries + 1)
            check(busy > 0, f"dual A/B {label}: the profiler saw no device time")
            row.update(busy_ms=busy, busy_ms_per_pool_step=busy / max(d["decode_steps"], 1))
        log(f"dual A/B {label}{' profiled' if profiled else ''}: wall {wall:.3f} s (files "
            + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()) + f" s), {d['tokens']} "
            f"tokens, {row['tokens_per_s']:.1f} tokens/s, {d['decode_steps']} pool decode steps "
            f"({d['dual_decodes']} dual decodes, {d['verify_rounds']} verify rounds)"
            + (f", device busy {row['busy_ms']:.1f} ms, "
               f"{row['busy_ms_per_pool_step']:.3f} ms a pool step" if profiled else ""))
        return row, tokens, {k: v for k, v in counts.items() if v}

    try:
        unfused, tok_u, launches_u = run(False, False)
        fused, tok_f, launches_f = run(True, False)
        unfused["profiled"] = run(False, True)[0]
        fused["profiled"] = run(True, True)[0]
    finally:
        engine.fuse_dual = False
    div = {name: first_divergence(tok_f[name], tok_u[name], ("fused", "unfused"))
           for name in tok_u}
    log(f"dual A/B: fused against unfused tokens (printed, not checked): {div}")
    return dict(unfused=unfused, fused=fused, vs_unfused=div, launches=(launches_u, launches_f))


def load_phase(torch, engine) -> dict:
    """tools/loadtest.run_load on the warmed native batched engine:
    LOAD_STREAMS realtime sessions for LOAD_SECONDS s (the default 2.0 /
    1.5 s speech / silence cycle, the energy gate, speculative and eager
    finals on from fresh gates), launch counters set to 0 just before and
    read just after. Checks: no error, a commit a stream at least (the
    final flush commits each open segment), no graph captured on the
    request path, decode attention, log_mel and verify attention launched.
    -> run_load's dict, the device round trip and capture probes, the
    classes' queue / run p50 / p95, host-path sessions, the traced tick
    phases, seconds, launches."""
    from sonicscribe_tpu_torch.config import AppConfig
    from sonicscribe_tpu_torch.ops import _build
    from sonicscribe_tpu_torch.tools.loadtest import (
        capture_probe_s,
        class_latency,
        device_rtt_ms,
        host_path_sessions,
        run_load,
    )

    engine.fuse_dual = False
    engine.spec_accept_ema = engine.eager_accept_ema = 1.0
    engine._eager_probe = 0
    engine._eager_pending.clear()
    engine.stats.pop("short_lat_ms", None)
    engine.stats.pop("long_lat_ms", None)
    engine.spans.clear()
    host_path = host_path_sessions(engine, LOAD_STREAMS)
    stats0 = dict(engine.stats)
    on_run0 = engine.router.stats["captured_on_run"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    m = asyncio.run(run_load(engine, AppConfig(), LOAD_STREAMS, LOAD_SECONDS))
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    seconds = time.perf_counter() - t0
    captured = engine.router.stats["captured_on_run"] - on_run0
    delta = {k: engine.stats[k] - stats0.get(k, 0) for k in
             ("decode_steps", "verify_rounds", "mel_preps", "ring_prefill_programs",
              "prefill_programs", "requests", "eager_granted", "eager_denied")}
    check(m["errors"] == 0, f"load: {m['errors']} errors")
    check(m["committed_count"] >= LOAD_STREAMS,
          f"load: {m['committed_count']} commits for {LOAD_STREAMS} streams")
    check(captured == 0, f"load: {captured} graphs captured on the request path")
    for name in ("decode_attention", "log_mel", "verify_attention"):
        check(counts.get(name, 0) > 0, f"load: {name} never launched")
    lat = class_latency(engine)
    out = dict(run_load=m, device_rtt_ms=device_rtt_ms(), capture_probe_s=capture_probe_s(),
               short=lat.get("short"), long=lat.get("long"), host_path_sessions=host_path,
               captured_on_run=captured, seconds=seconds, engine=delta,
               spec_accept_ema=engine.spec_accept_ema, eager_accept_ema=engine.eager_accept_ema,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches={k: v for k, v in counts.items() if v},
               tick_phases=tick_split(engine))
    log("load " + json.dumps(out, default=float))
    return out


def batched_phase(torch, mode: str) -> tuple[dict, dict]:
    """build_runtime("nano-random") in `mode` on the batched engine (the
    default): the grid captured (graphs, seconds, memory; its 12 verify
    keys among them), the files at once, the 12 s request undrafted and
    drafted, the streams beside the 12 s file; in native also the decode
    runs by active slots. -> (launch counts summed over the files, drafts
    and streams, numbers)."""
    from sonicscribe_tpu_torch.config import AppConfig
    from sonicscribe_tpu_torch.engine.batcher import BatchedEngine
    from sonicscribe_tpu_torch.serve.runtime import build_runtime

    config = AppConfig()
    config.quant_mode = mode
    native = mode == "native"
    # native: the dual programs in the grid (the A/B below; off for the other
    # runs)
    config.fuse_dual_decode = native
    engine, vad, info = build_runtime("nano-random", "energy", config, seed=SEED)
    check(isinstance(engine, BatchedEngine) and info["engine"] == "batched",
          f"build_runtime built {type(engine).__name__} by default")
    if not native:  # the script's time: the int8 modes' batched runs at a cut depth
        engine = cut_batched(engine, BATCHED_INT8_LAYERS)
        gc.collect()
        log(f"batched {mode}: cut to {BATCHED_INT8_LAYERS} decoder layers")
    check(engine.fuse_dual == native and info["fuse_dual_decode"] == native,
          f"batched {mode}: fuse_dual {engine.fuse_dual}")
    try:
        torch.cuda.synchronize()
        resident0 = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        if native:
            boot = fast_boot(torch, engine, mode)
            w = dict(graphs=engine.router.stats["graphs"], seconds=boot["blocking_s"])
        else:
            boot = None
            w = engine.warmup(budgets=GRID_BUDGETS)
        check(registered_grid(engine) == expected_grid(engine),
              f"batched {mode}: the registered grid is not _grid()'s")
        check(engine._compiled_dual == (set(engine.dual_k_choices) if native else set()),
              f"batched {mode}: dual programs registered {engine._compiled_dual}")
        engine.fuse_dual = False  # the runs below as before; dual_ab turns it on
        cap = engine.router.stats["capture_s"]
        kinds: dict = {}
        for key, sec in cap.items():
            kinds.setdefault(key[0], []).append(sec)
        k64 = cap.get(("decode", "long", 64, None))
        verify_keys = [engine._verify_key(p, r, rows) for p, r, rows in engine._grid()["verify"]]
        check(len(verify_keys) == 12 and all(k in engine.router.entries for k in verify_keys),
              f"batched {mode}: the verify keys {verify_keys} were not all captured by warmup")
        grid = dict(graphs=w["graphs"], grid_s=w["seconds"], resident_before_gib=resident0,
                    resident_gib=torch.cuda.memory_allocated() / 2**30,
                    max_gib=torch.cuda.max_memory_allocated() / 2**30,
                    by_kind={k: dict(graphs=len(v), seconds=sum(v), max_s=max(v))
                             for k, v in kinds.items()},
                    decode_long_k64_full_s=k64,
                    pools_gib={p.name: sum(t.numel() * t.element_size()
                                           for t in p.state.values()) / 2**30
                               for p in engine.pools},
                    ring_gib=engine.ring.numel() * 2 / 2**30)
        log(f"batched {mode}: {w['graphs']} graphs captured in {w['seconds']:.1f} s ("
            + ", ".join(f"{k} {v['graphs']} in {v['seconds']:.1f} s, max {v['max_s']:.2f}"
                        for k, v in grid["by_kind"].items())
            + f"); long decode k=64 full {k64 and round(k64, 2)} s; resident "
            f"{resident0:.2f} -> {grid['resident_gib']:.2f} GiB, max {grid['max_gib']:.2f} GiB; "
            f"pools {grid['pools_gib']} GiB, ring {grid['ring_gib']:.3f} GiB")
        on_run0 = engine.router.stats["captured_on_run"]
        t0 = time.perf_counter()

        def done(part: str) -> None:  # where the phase's time goes
            log(f"batched {mode}: {part} done at {time.perf_counter() - t0:.1f} s")

        files = batched_files(torch, engine, vad, mode)
        done("files")
        drafts = batched_drafts(torch, engine, mode, boot and boot.pop("tokens"))
        done("drafts")
        streams = batched_streams(torch, engine, vad, mode)
        done("streams")
        ticks = batched_ticks(torch, engine) if native else None
        done("decode by slots")
        dual = dual_ab(torch, engine, vad) if native else None
        done("dual A/B")
        on_run = engine.router.stats["captured_on_run"] - on_run0
        check(on_run == 0, f"batched {mode}: {on_run} graphs captured on the request path")
        runs = (files["launches"], drafts["launches"], streams["launches"],
                *(dual["launches"] if dual else ()))
        launches = {k: sum(r.get(k, 0) for r in runs) for k in set().union(*runs)}
        load = load_phase(torch, engine) if native else None
        done("load")
        return launches, dict(grid=grid, boot=boot, files=files, drafts=drafts,
                              streams=streams, ticks=ticks, dual=dual, load=load)
    finally:
        engine.shutdown()


def draft_kinds(tokens, vocab: int) -> dict:
    """The drafts of a request whose greedy tokens are `tokens`: those
    tokens (golden), their first half then garbage, garbage only (each
    garbage token differs from greedy's)."""
    tokens = np.asarray(tokens, np.int32)
    shift = np.random.default_rng(SEED + 12).integers(1, vocab, len(tokens))
    garbage = ((tokens + shift) % vocab).astype(np.int32)
    half = len(tokens) // 2
    return {"golden": tokens, "half then garbage": np.concatenate([tokens[:half], garbage[half:]]),
            "garbage": garbage}


def tiny_batched_phase(torch) -> None:
    """tiny() f32 on the batched engine: the card (graphs captured by
    warmup, kernels) gives the tokens of the CPU (the same programs run
    eagerly, plain versions) for five concurrent requests; a request
    undrafted and with each of draft_kinds gives the same tokens every
    time, on the card as on the CPU, with the same verify rounds; and a
    stepped stream session the same messages."""
    from sonicscribe_tpu_torch.config import AppConfig
    from sonicscribe_tpu_torch.engine.batcher import BatchedEngine
    from sonicscribe_tpu_torch.vad.model import EnergyVad

    reqs = [(speech(0.8 + 0.5 * i, seed=23 + i), budget, hot) for i, (budget, hot) in
            enumerate([(8, None), (24, ["gpu"]), (15, None), (40, None), (21, ["a", "b"])])]
    frames, _, _ = stream_frames(TINY_STREAM_SPANS, seed=50)
    draft_audio = speech(1.6, seed=29)
    tokens, msgs, drafted, rounds = {}, {}, {}, {}
    for device in ("cpu", "cuda"):
        engine = BatchedEngine(tiny_transcriber(torch, device), EnergyVad(device=device),
                               slots=4, max_decode_tokens=64, n_streams=4)
        engine.warmup()

        async def run(engine=engine):
            rs = await asyncio.gather(*[engine.transcribe(a, SR, max_new_tokens=b, hotwords=h)
                                        for a, b, h in reqs])
            return [r.tokens for r in rs]

        async def run_drafts(engine=engine):
            base = await engine.transcribe(draft_audio, SR, max_new_tokens=40)
            out = {"undrafted": base.tokens}
            for name, d in draft_kinds(base.tokens, engine.cfg.decoder.vocab_size).items():
                r = await engine.transcribe(draft_audio, SR, max_new_tokens=40, draft_tokens=d)
                out[name] = r.tokens
            return out

        try:
            tokens[device] = asyncio.run(run())
            if device == "cuda":
                default_graphs = engine.router.stats["graphs"]
            r0 = engine.stats["verify_rounds"]
            drafted[device] = asyncio.run(run_drafts())
            rounds[device] = engine.stats["verify_rounds"] - r0
            msgs[device] = asyncio.run(drive_stepped(AppConfig(), engine, frames))
        finally:
            engine.shutdown()
    for device, runs in drafted.items():
        for name, toks in runs.items():
            check(np.array_equal(toks, runs["undrafted"]),
                  f"tiny f32 batched {device}: the {name} draft gave other tokens: {toks} vs "
                  f"{runs['undrafted']}")
            check(np.array_equal(toks, drafted["cpu"][name]),
                  f"tiny f32 batched: the {name} run differs, cuda {toks} vs cpu "
                  f"{drafted['cpu'][name]}")
    check(rounds["cuda"] > 0 and rounds["cuda"] == rounds["cpu"],
          f"tiny f32 batched drafts: verify rounds cuda {rounds['cuda']}, cpu {rounds['cpu']}")
    log(f"reference: tiny f32 batched drafts (golden, half then garbage, garbage): "
        f"{len(drafted['cpu']['undrafted'])} tokens, drafted = undrafted and cuda = cpu, "
        f"{rounds['cuda']} verify rounds on each")
    check(all(np.array_equal(a, b) for a, b in zip(tokens["cuda"], tokens["cpu"]))
          and any(len(t) for t in tokens["cpu"]),
          f"tiny f32 batched: tokens differ: cuda {tokens['cuda']} cpu {tokens['cpu']}")
    kinds = [m["type"] for m in msgs["cpu"]]
    check(msgs["cuda"] == msgs["cpu"], "tiny f32 batched stream: the card's messages differ "
          f"from the CPU's:\n  cuda {msgs['cuda']}\n  cpu  {msgs['cpu']}")
    check(kinds.count("committed_output") == 2 and "tentative_output" in kinds,
          f"tiny f32 batched stream: messages {kinds}")
    log(f"reference: tiny f32 batched, 5 concurrent requests: tokens equal on cuda (graphs) and "
        f"cpu; stream: {kinds.count('tentative_output')} tentative and "
        f"{kinds.count('committed_output')} committed messages equal")
    tiny_boot_dual_heal(torch, reqs, default_graphs)


def tiny_boot_dual_heal(torch, reqs, default_graphs: int) -> None:
    """tiny() f32 on the card, on an engine built with fuse_dual_decode:
    a fast boot (a request before the deferred keys land and after the
    drain: equal tokens, nothing captured on its path); the dual decode
    (short and long requests at once, fused then unfused: equal tokens,
    dual decodes > 0 fused); a crash and its heal (tick_stall_dump_s /
    tick_stall_abort_s 0.1 / 0.3 s, the tick a 2 s sleep: the request
    fails, alive turns False, start() raises while the tick is stuck; after
    it drains, the next request's tokens are the pre-crash tokens and no
    graph is captured again). Then warmup(full=True) on another engine:
    its graphs against the default grid's (default_graphs)."""
    from sonicscribe_tpu_torch.engine.batcher import BatchedEngine
    from sonicscribe_tpu_torch.vad.model import EnergyVad

    def build(**kw):
        return BatchedEngine(tiny_transcriber(torch, "cuda"), EnergyVad(device="cuda"), slots=4,
                             max_decode_tokens=64, n_streams=4, **kw)

    audio, budget = reqs[3][0], reqs[3][1]  # a long-pool request
    mixed = ([(speech(0.6, seed=70 + i), 12) for i in range(3)]
             + [(a, b) for a, b, _ in reqs[1:4]])
    engine = build(fuse_dual_decode=True)
    rs = engine.router.stats
    try:
        w = engine.warmup(fast=True)
        on_run0 = rs["captured_on_run"]
        before = asyncio.run(engine.transcribe(audio, SR, max_new_tokens=budget)).tokens
        check(rs["captured_on_run"] == on_run0, "tiny fast boot: a graph captured on the "
              "request path before the deferred keys landed")
        engine.warmup_join()
        drain_s = engine.drain_replays()
        check(engine.stats["warmup_capture_failures"] == 0 and not engine._replay_queue,
              f"tiny fast boot: {engine.stats['warmup_capture_failures']} captures failed")
        after = asyncio.run(engine.transcribe(audio, SR, max_new_tokens=budget)).tokens
        check(len(before) > 0 and np.array_equal(before, after),
              f"tiny fast boot: tokens before the drain {before}, after {after}")
        log(f"reference: tiny f32 fast boot: {w['graphs']} graphs blocking, {w['deferred']} "
            f"deferred, drained in {drain_s:.2f} s ({rs['graphs']} graphs); the request's "
            f"{len(before)} tokens equal before and after the drain")

        async def run_mixed():
            out = await asyncio.gather(*[engine.transcribe(a, SR, max_new_tokens=b)
                                         for a, b in mixed])
            return [r.tokens for r in out]

        runs = {}
        for fused in (True, False):
            engine.fuse_dual = fused
            d0 = engine.stats["dual_decodes"]
            runs[fused] = (asyncio.run(run_mixed()), engine.stats["dual_decodes"] - d0)
        engine.fuse_dual = False
        check(runs[True][1] > 0 and runs[False][1] == 0,
              f"tiny dual: dual decodes fused {runs[True][1]}, unfused {runs[False][1]}")
        check(all(np.array_equal(a, b) for a, b in zip(runs[True][0], runs[False][0])),
              f"tiny dual: fused tokens {runs[True][0]} differ from unfused {runs[False][0]}")
        check(rs["captured_on_run"] == on_run0, "tiny dual: graphs captured on the request path")
        log(f"reference: tiny f32 dual decode: {len(mixed)} requests (3 short, 3 long) at once, "
            f"{runs[True][1]} dual decodes; fused tokens equal unfused")

        graphs0, real_tick = rs["graphs"], engine._tick
        engine.tick_stall_dump_s, engine.tick_stall_abort_s = 0.1, 0.3
        engine._tick = lambda *_a, **_k: time.sleep(2.0)

        async def crash():
            try:
                await asyncio.wait_for(engine.transcribe(audio, SR, max_new_tokens=budget), 20)
                return "completed", None
            except RuntimeError:
                pass
            t0 = time.perf_counter()
            while engine.alive and time.perf_counter() - t0 < 10:
                await asyncio.sleep(0.01)
            refused = None
            if engine._tick_busy:
                try:
                    await engine.start()
                    refused = False
                except RuntimeError as e:
                    refused = "still" in str(e)
            dead = not engine.alive
            while engine._tick_busy and time.perf_counter() - t0 < 20:
                await asyncio.sleep(0.01)
            return ("failed" if dead else "alive"), refused

        outcome, refused = asyncio.run(crash())
        check(outcome == "failed" and refused is True and not engine._tick_busy,
              f"tiny crash: request {outcome}, start() refused while stuck: {refused}, "
              f"busy {engine._tick_busy}")
        engine._tick = real_tick
        engine.tick_stall_dump_s, engine.tick_stall_abort_s = 60.0, 600.0
        healed = asyncio.run(engine.transcribe(audio, SR, max_new_tokens=budget)).tokens
        check(engine.alive and np.array_equal(healed, before) and rs["graphs"] == graphs0,
              f"tiny heal: alive {engine.alive}, tokens {healed} vs {before}, graphs "
              f"{rs['graphs']} vs {graphs0}")
        log("reference: tiny f32 crash and heal: the wedged request failed, alive False, start() "
            "refused while the tick was stuck; healed: the pre-crash tokens, no graph captured "
            "again")
    finally:
        engine.shutdown()
    full = build()
    try:
        wf = full.warmup(full=True)
        check(wf["graphs"] > default_graphs and registered_grid(full) == expected_grid(full, full=True),
              f"tiny --warmup-full: {wf['graphs']} graphs against the default's {default_graphs}")
        log(f"reference: tiny f32 warmup(full=True): {wf['graphs']} graphs in "
            f"{wf['seconds']:.1f} s, the default grid {default_graphs}")
    finally:
        full.shutdown()


# ---------------------------------------------------------------------
# the Silero VAD and the checkpoint tools
# ---------------------------------------------------------------------

SILERO_TOL = 1e-5  # a gate window's probabilities and states, card against CPU
SILERO_FILE_TOL = 1e-4  # window_probs over the 35 s file: ~1,100 LSTM steps
SILERO_STREAMS = 8
CKPT_LAYERS = 2  # the checkpoint path's encoder and decoder depth at nano's widths


def _sync_ms(torch, fn, iters: int = 20) -> float:
    """Median wall ms of fn() with the card synchronized after each call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _replay_ms(torch, engine, B: int) -> float:
    """Median device ms of the ring VAD program of batch B, replayed alone."""
    key, fn, bufs = engine._vad_ring_entry(B)
    pairs = []
    with torch.inference_mode():
        for _ in range(20):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            engine.router.run(key, fn, bufs)
            b.record()
            pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def silero_phase(torch) -> dict:
    """The Silero VAD on the card: a seeded tree against the same tree on
    the CPU over one gate window (20 sub-windows) at B 1, 16, 64 and over
    the 35 s file (window_probs); tiny f32 batched engines built with
    SileroCostProbeVad and with EnergyVad: their ring VAD programs' replays
    at B 16 and 64, and 8 stepped streams each (no graph captured on the
    request path, the same commits); the threaded engine's gate window with
    Silero. Then the checkpoint tools at nano's widths, CKPT_LAYERS layers:
    export_hf_checkpoint as BF16 safetensors, convert_hf_checkpoint,
    load_checkpoint onto the card (the tree's bits), a 12 s request's tokens
    from the loaded tree equal to the in-memory tree's, and
    verify_checkpoint on the card (rc 0, twin passed). -> its numbers."""
    import shutil
    import tempfile
    from dataclasses import replace

    from sonicscribe_tpu_torch.config import AppConfig
    from sonicscribe_tpu_torch.engine.batcher import BatchedEngine
    from sonicscribe_tpu_torch.engine.transcriber import Transcriber
    from sonicscribe_tpu_torch.models.config import nano
    from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
    from sonicscribe_tpu_torch.models.weights import init_random, load_checkpoint
    from sonicscribe_tpu_torch.serve.engine_async import ThreadedEngine
    from sonicscribe_tpu_torch.tools.convert_weights import _flatten, convert_hf_checkpoint
    from sonicscribe_tpu_torch.tools.export_hf import export_hf_checkpoint
    from sonicscribe_tpu_torch.tools.verify_checkpoint import print_report, verify
    from sonicscribe_tpu_torch.vad.model import (
        WINDOW_SAMPLES,
        EnergyVad,
        SileroCostProbeVad,
        SileroVad,
        window_probs,
    )

    out: dict = {}
    vads = {d: SileroVad(device=d, seed=SEED) for d in ("cpu", "cuda")}
    window = 20 * WINDOW_SAMPLES
    for B in (1, 16, 64):
        x = np.stack([(speech if i % 3 else silence)(window / SR, 60 + i)[:window]
                      for i in range(B)]).reshape(B, 20, WINDOW_SAMPLES)
        got = {}
        for d, vad in vads.items():
            state = vad.init_state(B)
            state["h"] += 0.1  # a stream mid-way
            with torch.inference_mode():
                probs, state = vad.forward_windows(vad.params, torch.from_numpy(x).to(d), state)
            got[d] = [probs.cpu()] + [state[k].cpu() for k in ("h", "c", "ctx")]
        err = max(float((a - b).abs().max()) for a, b in zip(got["cuda"], got["cpu"]))
        check(err <= SILERO_TOL, f"silero B={B}: card against CPU {err} > {SILERO_TOL}")
        xc = torch.from_numpy(x).cuda()
        with torch.inference_mode():
            ms = _sync_ms(torch, lambda: vads["cuda"].forward_windows(
                vads["cuda"].params, xc, vads["cuda"].init_state(B)))
        out[f"window_B{B}"] = dict(max_abs_err=err, eager_ms=ms)
        log(f"silero: one gate window (20 sub-windows) at B={B}, card against CPU max |err| "
            f"{err:.2e} (tol {SILERO_TOL}), probabilities {float(got['cpu'][0].min()):.4f}-"
            f"{float(got['cpu'][0].max()):.4f}; eager forward_windows {ms:.3f} ms")

    audio = payloads()["35s"]
    p_cpu = window_probs(vads["cpu"], audio)
    p_cuda = window_probs(vads["cuda"], audio)
    err = float(np.abs(p_cuda - p_cpu).max())
    check(p_cuda.shape == p_cpu.shape and err <= SILERO_FILE_TOL,
          f"silero window_probs 35 s: card against CPU {err} > {SILERO_FILE_TOL}")
    ms = _sync_ms(torch, lambda: window_probs(vads["cuda"], audio), iters=5)
    e_ms = _sync_ms(torch, lambda: window_probs(EnergyVad(device="cuda"), audio), iters=5)
    out["file_35s"] = dict(windows=len(p_cpu), max_abs_err=err, ms=ms, energy_ms=e_ms)
    log(f"silero: window_probs of the 35 s file ({len(p_cpu)} windows) card against CPU max "
        f"|err| {err:.2e} (tol {SILERO_FILE_TOL}); {ms:.2f} ms on the card (energy {e_ms:.2f})")
    out["twin"] = silero_twin(torch)

    # tiny f32 batched engines, the cost probe against the energy gate
    config = AppConfig()
    streams = [stream_frames(TINY_STREAM_SPANS, seed=70 + 10 * i)[0]
               for i in range(SILERO_STREAMS)]
    engines, commits = {}, {}
    for name, vad in (("probe", SileroCostProbeVad(device="cuda", seed=SEED)),
                      ("energy", EnergyVad(device="cuda"))):
        engine = BatchedEngine(tiny_transcriber(torch, "cuda"), vad, slots=4,
                               max_decode_tokens=64, n_streams=SILERO_STREAMS)
        engines[name] = engine
        engine.warmup()
        graphs0 = engine.router.stats["graphs"]
        on_run0 = engine.router.stats["captured_on_run"]

        async def run(engine=engine):
            return await asyncio.gather(*[drive_stepped(config, engine, f) for f in streams])

        t0 = time.perf_counter()
        msgs = asyncio.run(run())
        wall = time.perf_counter() - t0
        captured = engine.router.stats["graphs"] - graphs0
        check(captured == 0 and engine.router.stats["captured_on_run"] == on_run0,
              f"silero {name} engine: {captured} graphs captured on the streams' path")
        commits[name] = [[(m["segment_id"], m["start_chunk_id"], m["end_chunk_id"], m["text"])
                          for m in ms if m["type"] == "committed_output"] for ms in msgs]
        out[f"streams_{name}"] = dict(wall_s=wall, graphs=graphs0, captured=captured,
                                      commits=sum(len(c) for c in commits[name]))
    for i, (a, b) in enumerate(zip(commits["probe"], commits["energy"])):
        check([c[:3] for c in a] == [c[:3] for c in b] and a,
              f"silero probe stream {i}: commits {a}, the energy engine's {b}")
    same_text = sum(x == y for a, b in zip(commits["probe"], commits["energy"])
                    for x, y in zip(a, b))
    for B in (16, 64):
        out[f"vad_ring_B{B}_ms"] = {name: _replay_ms(torch, e, B) for name, e in engines.items()}
    for e in engines.values():
        e.shutdown()
    log(f"silero: {SILERO_STREAMS} stepped streams on tiny f32 batched engines, the cost probe "
        f"and the energy gate: 0 graphs captured on the request path, the same "
        f"{out['streams_probe']['commits']} commits ({same_text} with the same text), walls "
        f"{out['streams_probe']['wall_s']:.2f} / {out['streams_energy']['wall_s']:.2f} s; ring "
        f"VAD program replays, probe / energy: B=16 "
        f"{out['vad_ring_B16_ms']['probe']:.4f} / {out['vad_ring_B16_ms']['energy']:.4f} ms, "
        f"B=64 {out['vad_ring_B64_ms']['probe']:.4f} / {out['vad_ring_B64_ms']['energy']:.4f} ms")
    del engines

    threaded = ThreadedEngine(None, vads["cuda"])
    gate = speech(10 * CHUNK_SAMPLES / SR, 80)
    state = threaded._vad_window(gate, None)[1]
    ms = _sync_ms(torch, lambda: threaded._vad_window(gate, state))
    threaded_energy = ThreadedEngine(None, EnergyVad(device="cuda"))
    e_ms = _sync_ms(torch, lambda: threaded_energy._vad_window(gate, None))
    threaded.shutdown()
    threaded_energy.shutdown()
    out["threaded_window_ms"] = dict(silero=ms, energy=e_ms)
    log(f"silero: ThreadedEngine gate window (20 sub-windows) {ms:.3f} ms (energy {e_ms:.3f})")

    # the checkpoint tools at nano's widths
    cfg = nano()
    cfg = replace(cfg, encoder=replace(cfg.encoder, n_layers=CKPT_LAYERS),
                  decoder=replace(cfg.decoder, n_layers=CKPT_LAYERS))
    root = tempfile.mkdtemp(prefix="sonic_ckpt_smoke_")
    hf, native = os.path.join(root, "hf"), os.path.join(root, "native")

    def gb(path):
        return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path)
                   for f in fs) / 1e9

    try:
        params = init_random(cfg, SEED, dtype=torch.bfloat16, device="cuda")
        steps = {}
        t0 = time.perf_counter()
        export_hf_checkpoint(params, cfg, hf, dtype=torch.bfloat16)
        steps["export_hf"] = dict(s=time.perf_counter() - t0, gb=gb(hf))
        t0 = time.perf_counter()
        check(convert_hf_checkpoint(hf, native, progress=lambda _m: None) == cfg,
              "checkpoint: the derived config is not the tree's")
        steps["convert"] = dict(s=time.perf_counter() - t0, gb=gb(native))
        t0 = time.perf_counter()
        cfg2, loaded, tok = load_checkpoint(native, device="cuda")
        torch.cuda.synchronize()
        steps["load"] = dict(s=time.perf_counter() - t0,
                             gb=sum(t.numel() * t.element_size()
                                    for t in _flatten(loaded).values()) / 1e9)
        a, b = _flatten(params), _flatten(loaded)
        check(cfg2 == cfg and sorted(a) == sorted(b)
              and all(b[k].device.type == "cuda" and b[k].dtype == a[k].dtype
                      and torch.equal(a[k].view(torch.int16), b[k].view(torch.int16))
                      for k in a), "checkpoint: the loaded tree's bits are not the tree's")
        request = payloads()["12s"]
        toks = {}
        for name, tree in (("in_memory", params), ("loaded", loaded)):
            tr = Transcriber(cfg, tree, ByteTokenizer(cfg))
            t0 = time.perf_counter()
            toks[name] = tr.transcribe(request, SR, max_new_tokens=GRID_BUDGETS[-1]).tokens
            steps[f"request_{name}"] = dict(s=time.perf_counter() - t0, tokens=len(toks[name]))
            del tr
        check(len(toks["loaded"]) > 0 and np.array_equal(toks["loaded"], toks["in_memory"]),
              f"checkpoint: the loaded tree's 12 s tokens differ: {toks}")
        del loaded
        gc.collect()
        t0 = time.perf_counter()
        report = verify(hf, out=os.path.join(root, "verified"), device="cuda")
        steps["verify"] = dict(s=time.perf_counter() - t0)
        passed = print_report(report)
        twin = next(r for r in report if r["step"] == "twin")
        check(passed and twin["status"] == "ok",
              f"checkpoint: verify_checkpoint --device cuda failed: {report}")
        out["checkpoint"] = dict(layers=CKPT_LAYERS, steps=steps,
                                 report={r["step"]: r["status"] for r in report})
        log("silero checkpoint path (nano widths, encoder and decoder at "
            f"{CKPT_LAYERS} layers): " + "; ".join(
                f"{k} {v['s']:.2f} s" + (f", {v['gb']:.3f} GB" if "gb" in v else "")
                for k, v in steps.items())
            + f"; the loaded bits are the tree's, the 12 s request's {len(toks['loaded'])} "
            f"tokens equal; verify_checkpoint rc 0, twin: {twin['detail']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


SILERO_TWIN_TOL = 1e-4  # the twin's modules against SileroVad's ops, the 12 s file's windows


def silero_twin(torch) -> dict:
    """The independent twin (tools/torch_silero.py: upstream names, plain
    torch modules) on the card: its upstream-named state dict through the
    port's converter into SileroVad, whose window_probs over the ~12 s
    file on the card are held to the twin's probabilities, window by
    window with its state threaded, on the card. -> windows, error."""
    from sonicscribe_tpu_torch.tools.convert_silero import convert_state_dict
    from sonicscribe_tpu_torch.tools.torch_silero import TorchSileroVad, synthetic_state_dict
    from sonicscribe_tpu_torch.vad.model import WINDOW_SAMPLES, SileroVad, window_probs

    with torch.random.fork_rng(devices=[]):  # the twin seeds torch's generator
        sd = synthetic_state_dict(seed=SEED)
        twin = TorchSileroVad(seed=SEED).cuda()
    vad = SileroVad(params=convert_state_dict(sd), device="cuda")
    audio = payloads()["12s"]
    n = len(audio) // WINDOW_SAMPLES
    x = torch.from_numpy(audio[: n * WINDOW_SAMPLES].reshape(n, WINDOW_SAMPLES)).cuda()
    want = torch.stack([twin(x[i:i + 1], SR) for i in range(n)]).cpu().numpy()[:, 0]
    got = window_probs(vad, audio[: n * WINDOW_SAMPLES])
    err = float(np.abs(got - want).max())
    check(got.shape == want.shape and err <= SILERO_TWIN_TOL,
          f"silero twin: SileroVad on the card against TorchSileroVad {err} > {SILERO_TWIN_TOL}")
    log(f"silero: the twin's upstream-named state dict through convert_silero: SileroVad "
        f"against TorchSileroVad on the card over the 12 s file ({n} windows) max |err| "
        f"{err:.2e} (tol {SILERO_TWIN_TOL}), probabilities {want.min():.4f}-{want.max():.4f}")
    return dict(windows=n, max_abs_err=err)


def weight_scale_phase(torch) -> None:
    """Weights quantized on the card (build_runtime's path) against the same
    weights quantized on the CPU, at nano's projection shapes (two layers,
    bf16 as nano-random): the columns whose scale or codes differ, with the
    old formula (`/ 127.0`, which PyTorch runs on the card as a multiply by
    the reciprocal) inline, and with quantize_tensor, which must give none."""
    from sonicscribe_tpu_torch.models.config import nano
    from sonicscribe_tpu_torch.ops.quant import quantize_tensor

    def old_formula(w):
        wf = w.float()
        scale = torch.clamp(wf.abs().amax(dim=-2, keepdim=True), min=1e-8) / 127.0
        return {"q": torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8),
                "scale": scale}

    def columns_differ(got, want) -> int:
        bad = (got["scale"].cpu() != want["scale"]) | (got["q"].cpu() != want["q"]).any(
            dim=-2, keepdim=True)
        return int(bad.sum())

    cfg = nano()
    dec, enc = cfg.decoder, cfg.encoder
    d, e = dec.d_model, enc.d_model
    shapes = {  # the nine quantized keys (o_w names the decoder's and the encoder's)
        "qkv_w": (d, (dec.n_heads + 2 * dec.n_kv_heads) * dec.head_dim),
        "o_w": (dec.n_heads * dec.head_dim, d), "gate_up_w": (d, 2 * dec.ffn_hidden),
        "down_w": (dec.ffn_hidden, d), "q_w": (e, e), "k_w": (e, e), "v_w": (e, e),
        "enc o_w": (e, e), "fc1_w": (e, enc.ffn_mult * e), "fc2_w": (enc.ffn_mult * e, e),
    }
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    n_cols = old = new = 0
    for K, N in shapes.values():
        w = (torch.randn((2, K, N), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        want = quantize_tensor(w.cpu())
        n_cols += 2 * N
        old += columns_differ(old_formula(w), want)
        new += columns_differ(quantize_tensor(w), want)
    log(f"weight scales quantized on the card vs the CPU (nano's {len(shapes)} projection "
        f"weights, 2 layers, {n_cols} columns): old formula {old} columns differ, "
        f"quantize_tensor {new}")
    check(new == 0, f"quantize_tensor on the card differs from the CPU in {new} columns")


def micro_phase(torch) -> dict:
    """The decode microbenches' legs (tools/bench_hbm, bench_decode_parts,
    bench_decode, bench_rows, bench_flash) at full width, nano bf16 with its
    28 layers, with MICRO_REPS timed programs a leg. Checks: every read rate
    above 0 and at most the data sheet's x 1.05; the split by op covers at
    least MICRO_COVERAGE of the profiled busy time and holds one decode-
    attention split kernel per layer and step; rows parity in float32 (the
    bench raises otherwise); the routes' attention within
    bench_flash.AGREE_TOL of each other; every time above 0. -> the twins'
    results and the phase's seconds."""
    from sonicscribe_tpu_torch.models.config import nano
    from sonicscribe_tpu_torch.models.weights import init_random
    from sonicscribe_tpu_torch.tools import (
        bench_decode,
        bench_decode_parts,
        bench_flash,
        bench_hbm,
        bench_rows,
    )

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = nano()
    out, seconds = {}, {}

    def timed(name, fn):
        t1 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t1

    timed("hbm", lambda: bench_hbm.measure(dev, reps=MICRO_HBM_REPS))
    for name, r in out["hbm"].items():
        check(0 < r["eff_gb_s"] <= bench_hbm.DATASHEET_GB_S * bench_hbm.RATE_SLACK,
              f"micro hbm {name}: {r['eff_gb_s']} GB/s is outside (0, "
              f"{bench_hbm.DATASHEET_GB_S} x {bench_hbm.RATE_SLACK}]")
        log(f"micro hbm {name}: {r['eff_gb_s']:.1f} GB/s, {r['ms']:.3f} ms a read of "
            f"{r['bytes']} B; kernels " + "; ".join(
                f"{k['name'][:60]} x{k['count']} {k['ms']:.3f} ms" for k in r["kernels"]))
    rate = out["hbm"]["bf16_flat"]["eff_gb_s"]
    params = init_random(cfg, SEED, dtype=torch.bfloat16, device=dev)
    timed("decode_parts", lambda: bench_decode_parts.measure(params, cfg, dev, reps=MICRO_REPS,
                                                             rate_gb_s=rate))
    parts = out["decode_parts"]
    split = parts["split_by_op"]
    log(f"micro decode_parts: mlp_chain {parts['mlp_chain_ms_per_step']:.3f}, attn_chain "
        f"{parts['attn_chain_ms_per_step']:.3f}, lm_head {parts['lm_head_ms_per_step']:.3f}, "
        f"full {parts['full_ms_per_step']:.3f} ms a step; rooflines weights "
        f"{parts['roofline_weights_ms']:.3f} ({parts['roofline_weights_ms_measured']:.3f} at "
        f"{rate:.0f} GB/s), KV read {parts['roofline_kv_read_ms']:.3f} ms; split ({split['source']}"
        f", {split['steps']} steps, profile {split['profile_tries']}): busy "
        f"{split['busy_ms_per_step']:.3f} ms, {split['kernels_per_step']:.1f} kernels a step, "
        f"coverage {split['coverage']:.4f}")
    for g, r in split["groups"].items():
        log(f"  {g}: {r['ms_per_step']:.4f} ms, {r['kernels_per_step']:.2f} kernels a step")
    check(split["coverage"] >= MICRO_COVERAGE,
          f"micro split by op: the groups cover {split['coverage']:.4f} of the busy time "
          f"(< {MICRO_COVERAGE}); other: {split['other_names'][:8]}")
    want = cfg.decoder.n_layers * split["steps"]
    check(split["decode_attention_split_kernels"] == want,
          f"micro split by op: {split['decode_attention_split_kernels']} decode-attention "
          f"kernels in the profile for {want} calls")
    timed("decode", lambda: bench_decode.measure(params, cfg, dev, pools=bench_decode.POOLS[:1],
                                                 reps=MICRO_REPS, rate_gb_s=rate))
    d = out["decode"]
    log(f"micro decode pool50x896: graph {d['pool50x896_graph_ms_per_step']:.3f}, eager "
        f"{d['pool50x896_eager_ms_per_step']:.3f} ms a step (capture "
        f"{d['pool50x896_graph_capture_s']:.2f} s)")

    def rows():
        params32 = init_random(cfg, SEED, dtype=torch.float32, device=dev)
        try:
            return bench_rows.measure(params32, params, cfg, dev, rows_choices=(4, None),
                                      n_iters=MICRO_REPS)
        finally:
            del params32

    timed("rows", rows)
    for label, r in out["rows"]["results"].items():
        check(r["parity"] == "ok", f"micro rows {label}: parity {r['parity']}")
        log(f"micro rows {label}: k8 program {r['k8_program_ms_med']:.3f} ms (min "
            f"{r['k8_program_ms_min']:.3f}), bf16 tokens match full {r['token_match_vs_full']:.3f}"
            f", capture {r['capture_s']:.2f} s; float32 parity {r['parity']}")
    torch.cuda.empty_cache()
    timed("flash", lambda: bench_flash.measure(params, cfg, dev, iters=MICRO_REPS,
                                               occupancies=(64, -8)))
    for key, v in out["flash"].items():
        if key.endswith("_agreement"):
            check(v <= bench_flash.AGREE_TOL, f"micro flash {key}: the routes' attention "
                  f"{v:.3g} of max|kernel| apart (> {bench_flash.AGREE_TOL})")
    log("micro flash: " + ", ".join(f"{k} {v:.4g}" for k, v in out["flash"].items()
                                    if k.startswith("occ")))

    def times(node, path=""):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from times(v, f"{path}.{k}")
        elif ("_ms" in path or path.endswith(".ms")) and "roofline" not in path \
                and ".groups." not in path:  # an op group may hold no kernel
            yield path, node

    for path, v in times(out):
        check(isinstance(v, float) and v > 0, f"micro {path}: time {v} is not above 0")
    del params
    out["seconds"] = dict(seconds, total=time.perf_counter() - t0)
    log("micro " + json.dumps(out, default=float))
    return out


DP_REPLICAS = 2
DP_REQUESTS = 8  # tiny f32 host requests at once
DP_STREAMS = 4  # tiny f32 ring streams, spread over the replicas


def dp_devices(torch) -> list:
    """The replicas' cards: cuda:0 and cuda:1 where the machine has two,
    else cuda:0 twice."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i if n >= DP_REPLICAS else 0) for i in range(DP_REPLICAS)]


def dp_tiny(torch, devices) -> dict:
    """tiny() f32 over two replicas (engine/replicas.py) against one
    engine on cuda:0, both warmed: DP_REQUESTS host requests at once give
    the single engine's tokens; DP_STREAMS ring streams on the replicas
    (packed ingest, ring VAD, ring prefill) give the host path's tokens on
    their int16 audio; each replica's slots, ring and weights on its card,
    its decode steps and decode-attention launches (its router's replays)
    above 0; then the dry run's twin over the same cards."""
    from sonicscribe_tpu_torch.engine.batcher import BatchedEngine
    from sonicscribe_tpu_torch.engine.replicas import DataParallelEngine
    from sonicscribe_tpu_torch.parallel.dryrun import dryrun_multichip
    from sonicscribe_tpu_torch.parallel.mesh import make_mesh
    from sonicscribe_tpu_torch.vad.model import EnergyVad

    single = BatchedEngine(tiny_transcriber(torch, "cuda"), EnergyVad(device="cuda"), slots=8,
                           max_decode_tokens=64, n_streams=8)
    engine = DataParallelEngine(tiny_transcriber(torch, "cuda"), EnergyVad(device="cuda"),
                                make_mesh(devices=devices), slots=8, max_decode_tokens=64,
                                n_streams=2 * DP_STREAMS)
    for rep, dev in zip(engine.replicas, devices):
        check(rep.device == dev and rep.ring.device == dev
              and all(t.device == dev for p in rep.pools for t in p.state.values())
              and rep.transcriber.params["decoder"]["embed"].device == dev,
              f"dp tiny: a replica's state is not on {dev}")
    reqs = [(speech(0.8 + 0.3 * i, seed=40 + i), budget, ["gpu"] if i in (1, 4) else None)
            for i, budget in enumerate((8, 24, 15, 40, 21, 8, 30, 12))]
    audios = [speech(20 * CHUNK_SAMPLES / SR, seed=60 + i) for i in range(DP_STREAMS)]
    pcms = [(np.clip(a, -1, 1) * 32767).astype("<i2").tobytes() for a in audios]
    int16 = [np.frombuffer(p, "<i2").astype(np.float32) / 32768.0 for p in pcms]

    async def host(eng):
        rs = await asyncio.gather(*[eng.transcribe(a, SR, max_new_tokens=b, hotwords=h)
                                    for a, b, h in reqs])
        return [r.tokens for r in rs]

    async def ring(eng):
        streams = [eng.alloc_stream() for _ in audios]
        for s, p in zip(streams, pcms):
            for c in range(20):
                eng.ingest(s, c, p[c * 2048:(c + 1) * 2048])
        probs = await asyncio.gather(*[eng.vad_window_ring(s, 0) for s in streams])
        rs = await asyncio.gather(*[eng.transcribe_ring(s, 0, 20, max_new_tokens=24)
                                    for s in streams])
        for s in streams:
            eng.free_stream(s)
        return streams, probs, [r.tokens for r in rs]

    async def host_of(eng, xs):
        rs = await asyncio.gather(*[eng.transcribe(x, SR, max_new_tokens=24) for x in xs])
        return [r.tokens for r in rs]

    try:
        single.warmup()
        w = engine.warmup()
        want = asyncio.run(host(single))
        want_ring = asyncio.run(host_of(single, int16))
        steps0 = [r.stats["decode_steps"] for r in engine.replicas]
        got = asyncio.run(host(engine))
        streams, probs, got_ring = asyncio.run(ring(engine))
    finally:
        single.shutdown()
        engine.shutdown()
    check(all(np.array_equal(a, b) for a, b in zip(got, want)) and any(len(t) for t in want),
          f"dp tiny: the replicas' tokens differ from one engine's: {got} vs {want}")
    owners = sorted(s // engine.rows_per_replica for s in streams)
    check(owners == sorted(list(range(DP_REPLICAS)) * (DP_STREAMS // DP_REPLICAS)),
          f"dp tiny: streams {streams} not spread over the replicas")
    check(all(0.0 <= p <= 1.0 for p in probs), f"dp tiny: ring VAD probabilities {probs}")
    check(all(np.array_equal(a, b) for a, b in zip(got_ring, want_ring)),
          f"dp tiny: ring tokens {got_ring} differ from the host path's {want_ring}")
    steps = [r.stats["decode_steps"] - s0 for r, s0 in zip(engine.replicas, steps0)]
    attn = [r.router.stats["launches"].get("decode_attention", 0) for r in engine.replicas]
    check(all(n > 0 for n in steps) and all(n > 0 for n in attn),
          f"dp tiny: decode steps {steps}, decode-attention launches {attn} by replica")
    dry = dryrun_multichip(DP_REPLICAS, devices)
    log(f"dp tiny f32 on {[str(d) for d in devices]}: {w['graphs']} graphs warmed; "
        f"{DP_REQUESTS} host requests = one engine's tokens; {DP_STREAMS} ring streams on "
        f"replicas {owners} = the host path's tokens; decode steps {steps}, decode-attention "
        f"launches {attn} by replica; dry run over {dry['devices']} passed")
    return dict(graphs=w["graphs"], decode_steps=steps, decode_attention=attn,
                dryrun_tokens=sum(len(t) for t in dry["tokens"]))


def dp_load(torch, devices) -> dict:
    """Nano bf16 at full width over two replicas, each fast-booted: the
    deferred keys are dropped (an idle tick would otherwise capture them
    inside the window, the long k = 64 graph holding a replica's device
    thread for seconds), so the window serves on the blocking set. Then
    tools/loadtest.run_load with LOAD_STREAMS realtime streams for
    LOAD_SECONDS s, launch counters set to 0 just before and read just
    after. Checks: no error, a commit a stream at least, streams on both
    replicas, no graph captured on the request path, decode attention and
    log_mel launched, each replica's decode attention by its router.
    -> numbers."""
    from sonicscribe_tpu_torch.config import AppConfig
    from sonicscribe_tpu_torch.engine.replicas import DataParallelEngine
    from sonicscribe_tpu_torch.engine.transcriber import Transcriber
    from sonicscribe_tpu_torch.models.config import nano
    from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
    from sonicscribe_tpu_torch.models.weights import init_random
    from sonicscribe_tpu_torch.ops import _build
    from sonicscribe_tpu_torch.parallel.mesh import make_mesh
    from sonicscribe_tpu_torch.serve.runtime import build_runtime
    from sonicscribe_tpu_torch.tools.loadtest import captured_on_run, class_latency, run_load
    from sonicscribe_tpu_torch.vad.model import EnergyVad

    config = AppConfig()
    config.data_parallel = DP_REPLICAS
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    if len(set(devices)) == DP_REPLICAS:  # one card each: the server's own path
        engine, _vad, info = build_runtime("nano-random", "energy", config, seed=SEED)
        check(info["data_parallel"] == DP_REPLICAS and isinstance(engine, DataParallelEngine),
              f"dp: build_runtime gave {info['data_parallel']} replicas")
    else:  # one card: build_runtime would clamp to it; the same engine by hand
        mcfg = nano()
        params = init_random(mcfg, SEED, dtype=torch.bfloat16, device="cuda")
        tr = Transcriber(mcfg, params, ByteTokenizer(mcfg),
                         prefill_buckets=tuple(config.prefill_buckets))
        engine = DataParallelEngine(
            tr, EnergyVad(device="cuda"), make_mesh(devices=devices), slots=config.decode_slots,
            max_decode_tokens=max(config.file_max_new_tokens, config.final_max_tokens))
    build_s = time.perf_counter() - t0
    try:
        boot = engine.warmup(budgets=GRID_BUDGETS, fast=True)
        dropped = [len(r._replay_queue) for r in engine.replicas]
        for r in engine.replicas:
            r._replay_queue.clear()
            r._note_deferred()
        torch.cuda.synchronize()
        mem = dict(resident_gib=sum(torch.cuda.memory_allocated(d) for d in set(devices)) / 2**30,
                   max_gib=sum(torch.cuda.max_memory_allocated(d) for d in set(devices)) / 2**30,
                   pools_gib=[sum(t.numel() * t.element_size() for p in r.pools
                                  for t in p.state.values()) / 2**30 for r in engine.replicas])
        log(f"dp nano bf16 on {[str(d) for d in devices]}: built in {build_s:.1f} s; fast boots "
            f"{[round(w['seconds'], 1) for w in boot['replicas']]} s blocking on "
            f"{[w['graphs'] for w in boot['replicas']]} graphs, {dropped} deferred keys dropped; "
            f"resident {mem['resident_gib']:.2f} GiB, max {mem['max_gib']:.2f} GiB, pools "
            f"{[round(g, 2) for g in mem['pools_gib']]} GiB by replica")
        on_run0 = captured_on_run(engine)
        stats0 = [dict(r.stats) for r in engine.replicas]
        launches0 = [dict(r.router.stats["launches"]) for r in engine.replicas]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _build.reset_launch_counts()
        m = asyncio.run(run_load(engine, AppConfig(), LOAD_STREAMS, LOAD_SECONDS))
        for d in set(devices):
            torch.cuda.synchronize(d)
        counts = dict(_build.launch_counts)
        seconds = time.perf_counter() - t1
        captured = captured_on_run(engine) - on_run0
        per = [{k: r.stats[k] - s0.get(k, 0) for k in ("decode_steps", "requests",
                                                        "ring_prefill_programs")}
               for r, s0 in zip(engine.replicas, stats0)]
        attn = [r.router.stats["launches"].get("decode_attention", 0) - l0.get("decode_attention", 0)
                for r, l0 in zip(engine.replicas, launches0)]
        lat = class_latency(engine)
    finally:
        engine.shutdown()
    share = [n / max(1, sum(engine.allocated)) for n in engine.allocated]
    check(m["errors"] == 0, f"dp load: {m['errors']} errors")
    check(m["committed_count"] >= LOAD_STREAMS,
          f"dp load: {m['committed_count']} commits for {LOAD_STREAMS} streams")
    check(captured == 0, f"dp load: {captured} graphs captured on the request path")
    check(all(n > 0 for n in engine.allocated), f"dp load: streams by replica {engine.allocated}")
    check(all(p["decode_steps"] > 0 for p in per) and all(n > 0 for n in attn),
          f"dp load: by replica {per}, decode-attention launches {attn}")
    for name in ("decode_attention", "log_mel"):
        check(counts.get(name, 0) > 0, f"dp load: {name} never launched")
    out = dict(devices=[str(d) for d in devices], run_load=m, seconds=seconds,
               build_s=build_s, boot_s=[w["seconds"] for w in boot["replicas"]],
               boot_graphs=[w["graphs"] for w in boot["replicas"]], deferred_dropped=dropped,
               memory=mem, streams=engine.allocated, share=share, by_replica=per,
               decode_attention=attn, short=lat.get("short"), long=lat.get("long"),
               captured_on_run=captured, launches={k: v for k, v in counts.items() if v})
    log(f"dp load: {LOAD_STREAMS} streams x {LOAD_SECONDS} s over {DP_REPLICAS} replicas "
        f"(streams {engine.allocated}, share {[round(x, 3) for x in share]}): tentative p50 / "
        f"p95 {m['interim_p50_ms']} / {m['interim_p95_ms']} ms, committed "
        f"{m['committed_p50_ms']} / {m['committed_p95_ms']} ms, {m['committed_count']} commits, "
        f"ingest lag {m['max_ingest_lag_s']} s, 0 captures; decode steps "
        f"{[p['decode_steps'] for p in per]}, decode-attention launches {attn} by replica")
    return out


def dp_phase(torch) -> dict:
    devices = dp_devices(torch)
    log(f"dp: {DP_REPLICAS} replicas on {[str(d) for d in devices]} "
        f"({torch.cuda.device_count()} card(s) present)")
    tiny = dp_tiny(torch, devices)
    release_memory(torch)
    return dict(devices=[str(d) for d in devices], tiny=tiny, load=dp_load(torch, devices))


TP_DEGREE = 2
TP_REQUESTS = 8  # tiny f32 host requests at once
TP_STREAMS = 4  # tiny f32 ring streams
TP_ROWS = (1, 32)  # decode rows of the nano steps timed at tp = 2 and on one card
TP_STEP_REPS = 20  # replays of a timed step
TP_W8A8_ROWS = (1, 4, 16, 33)  # W8A8 at the shard shapes: the cluster design, then the s8 mma
TP_CACHE_LEN, TP_HISTORY = 256, 200  # the nano steps' cache positions and history
# nano bf16, one decode step at tp = 2 against one card, as a share of
# max|logits|: each rank's row-parallel partial sum is rounded to bf16
# before the all-reduce adds them (GSPMD's psum of bf16 partials does the
# same), where one card rounds the whole product once; over 28 layers of
# random weights that moved the logits by 3.1% of their maximum at 8 rows
# and 4.5% at 32 (the greedy token the same in 84% of the 32 rows)
TP_LOGIT_TOL = 0.08
# the same under int8-decoder-a8. Each row's scale is then max|x| / 127 of
# that row, and a value of x / sx near a half flips its int8 code at the
# least change of x: one flip moves the product's row by ~1e-3 of its
# maximum, which flips more codes in the next layers. On nano's random
# weights a step's 28 layers carry one rounding difference (bf16 partial
# sums; even float32 summation order) to the level of -a8's own error:
# both ranks' shards of one step against the whole tree's moved the logits
# by 17% / 20% of their maximum at 1 / 32 rows in bf16, 70% of the step's
# int8 codes flipped (11% at 32 rows in float32), where -a8 itself lies
# ~22% from the native step (tp_steps, tp_one_card; one H100 80GB HBM3 at
# 700 W, PERF.md). A logits bound cannot tell a fault from that here; the
# bit-exact check of every rank's int8 x against the whole row's recipe
# does (tp_a8_codes).
TP_A8_LOGIT_TOL = 0.35


class OneCardPair:
    """Both ranks of a tp pair on one card, each on a thread of its own:
    the one-card leg's stand-in for NCCL, which refuses two ranks on one
    card. Rank 0 adds the two partial sums in rank order once both are
    enqueued, and both ranks take the sum, or the elementwise maximum for
    op "max" (every op on the card's default stream, in the order the
    barriers give)."""

    def __init__(self, torch):
        import threading

        self.torch = torch
        self.size = TP_DEGREE
        self.barrier = threading.Barrier(TP_DEGREE, timeout=120)
        self.parts = [None] * TP_DEGREE
        self.total = None
        self.ops = [{"sum": 0, "max": 0} for _ in range(TP_DEGREE)]  # reduces by rank and op

    def all_reduce(self, rank: int, x, op: str = "sum"):
        self.parts[rank] = x
        self.ops[rank][op] += 1
        self.barrier.wait()
        if rank == 0:
            self.total = (self.parts[0] + self.parts[1] if op == "sum"
                          else self.torch.maximum(self.parts[0], self.parts[1]))
        self.barrier.wait()
        x.copy_(self.total)
        self.barrier.wait()
        return x

    def run(self, fn):
        import threading

        torch, out, errors = self.torch, [None] * TP_DEGREE, []

        def rank(r):
            try:
                with torch.inference_mode(), torch.cuda.device(0):
                    out[r] = fn(r)
            except BaseException as e:  # reported below, after both threads end
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=rank, args=(r,)) for r in range(TP_DEGREE)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        check(not errors and not any(t.is_alive() for t in threads),
              f"tp one card: a rank failed or hung: {errors}")
        return out


def tp_trees(torch, params, cfg, devices, group):
    """shard_params_tp's trees for `devices` (a pair; one card named twice
    in the one-card leg), each with its rank's reduce hook on `group`."""
    from sonicscribe_tpu_torch.models.config import tp_blocks
    from sonicscribe_tpu_torch.parallel.mesh import make_mesh, shard_params_tp
    from sonicscribe_tpu_torch.parallel.tp import TPRank

    shards = shard_params_tp(params, make_mesh(devices=devices, model_parallel=TP_DEGREE), cfg)
    blocks = tp_blocks(cfg, TP_DEGREE)
    return [dict(t, tp=TPRank(group, r, blocks)) for r, t in enumerate(shards)]


def tree_gib(tree) -> float:
    """Bytes of a tree's tensor leaves, in GiB."""
    if isinstance(tree, dict):
        return sum(tree_gib(v) for v in tree.values())
    return tree.numel() * tree.element_size() / 2**30 if hasattr(tree, "numel") else 0.0


def step_inputs(torch, cfg, rows: int, devices):
    """A decode step's inputs at nano: one card's cache [L, rows,
    TP_CACHE_LEN, nkv, hd] of random bf16 history TP_HISTORY long (from a
    seed), each rank's share of its KV heads on its device, and the
    tokens. -> (whole cache, [rank caches], tokens)."""
    dec = cfg.decoder
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 31 + rows)
    shape = (dec.n_layers, rows, TP_CACHE_LEN, dec.n_kv_heads, dec.head_dim)
    whole = {"k": (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(torch.bfloat16),
             "v": (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(torch.bfloat16),
             "len": torch.full((rows,), TP_HISTORY, dtype=torch.int32, device="cuda")}
    h = dec.n_kv_heads // TP_DEGREE
    shards = [{"k": whole["k"][:, :, :, r * h:(r + 1) * h].to(d, copy=True).contiguous(),
               "v": whole["v"][:, :, :, r * h:(r + 1) * h].to(d, copy=True).contiguous(),
               "len": whole["len"].to(d, copy=True)} for r, d in enumerate(devices)]
    tok = torch.randint(10, dec.vocab_size, (rows,), generator=gen, device="cuda",
                        dtype=torch.int32)
    return whole, shards, tok


def logits_agree(name, got, want, tol: float = TP_LOGIT_TOL) -> dict:
    """tp logits against one card's: max |diff| within tol (TP_LOGIT_TOL,
    or TP_A8_LOGIT_TOL under int8-decoder-a8) of max|want|, and the share
    of rows with the same greedy token."""
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    same = (got.float().argmax(-1) == want.float().argmax(-1)).float().mean().item()
    check(np.isfinite(err) and err <= tol * top,
          f"{name}: logits {err} from one card's (max |logits| {top}), beyond {tol} of it")
    return dict(max_abs_err=err, max_abs_logit=top, rel_err=err / top, argmax_same=same)


def tp_shard_kernels(torch) -> dict:
    """Each kernel of the tp path at nano's tp = 2 shard shapes on the card
    against its plain version: decode attention over a rank's 8 query and
    2 KV heads (S 1 and 32, M 803, bf16, ATTN_TOL, and timed), verify
    attention over them (S 4, W1 9: the tensor-core kernel), the stacked
    W8A16 entry at decode rows 1 and 32 on each projection's shard (N / 2
    for qkv and gate_up, K / 2 for o and down) and the flat one at 419
    prefill rows on the qkv and down shards (check_w16's tolerance); W8A8
    at TP_W8A8_ROWS on each shard with a given row_amax (the row's max over
    this share and another of the same width, as a row-parallel rank gets
    it from the max-reduce), through the entry and both designs forced,
    equal bits with the plain version under the same row_amax on CPU
    copies (both are the same integer sums scaled the same way), timed with
    and without it; and at the whole projections without a row_amax, equal
    bits with the plain version and with the call given each row's own
    max. -> numbers by kernel."""
    from sonicscribe_tpu_torch.models.config import nano
    from sonicscribe_tpu_torch.ops import int8_matmul as im
    from sonicscribe_tpu_torch.ops.decode_attention import (
        decode_attention_cuda,
        decode_attention_plain,
        verify_attention_cuda,
        verify_attention_plain,
    )
    from sonicscribe_tpu_torch.ops.quant import quantize_tensor

    dec = nano().decoder
    nh, nkv, hd = dec.n_heads // TP_DEGREE, dec.n_kv_heads // TP_DEGREE, dec.head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 41)
    timer = Timer(torch)
    out = {"decode_attention": {}, "verify_attention": {}, "int8_matmul_stacked": {},
           "int8_matmul": {}}
    M = VERIFY_M
    for S in TP_ROWS:
        k = torch.randn((S, M, nkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((S, M, nkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
        q = torch.randn((S, nh, hd), generator=gen, device="cuda").to(torch.bfloat16)
        lens = torch.randint(M // 2, M, (S,), generator=gen, device="cuda").to(torch.int32)
        err = (decode_attention_cuda(q, k, v, lens).float()
               - decode_attention_plain(q, k, v, lens)).abs().max().item()
        check(np.isfinite(err) and err <= ATTN_TOL,
              f"tp decode_attention S={S} nh={nh} nkv={nkv}: max err {err} > {ATTN_TOL}")
        ms = timer.ms(lambda: decode_attention_cuda(q, k, v, lens))
        out["decode_attention"][f"S{S}_M{M}_nkv{nkv}"] = dict(max_abs_err=err, ms=ms)
    S, W1 = 4, VERIFY_W1
    k = torch.randn((S, M, nkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((S, M, nkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    q = torch.randn((S, W1, nh, hd), generator=gen, device="cuda").to(torch.bfloat16)
    lens = torch.randint(M // 2, M - W1, (S,), generator=gen, device="cuda").to(torch.int32)
    err = (verify_attention_cuda(q, k, v, lens).float()
           - verify_attention_plain(q, k, v, lens)).abs().max().item()
    check(np.isfinite(err) and err <= ATTN_TOL,
          f"tp verify_attention S={S} W1={W1} nkv={nkv}: max err {err} > {ATTN_TOL}")
    out["verify_attention"][f"S{S}_W1{W1}_nkv{nkv}"] = dict(max_abs_err=err)
    F = dec.ffn_hidden
    shapes = {"qkv": (dec.d_model, (dec.n_heads + 2 * dec.n_kv_heads) * hd // TP_DEGREE),
              "o": (dec.n_heads * hd // TP_DEGREE, dec.d_model),
              "gate_up": (dec.d_model, F), "down": (F // TP_DEGREE, dec.d_model)}
    for name, (K, N) in shapes.items():
        w = torch.randn((2, K, N), generator=gen, device="cuda") * 0.05
        qt = quantize_tensor(w)
        for B in TP_ROWS:
            x = torch.randn((B, K), generator=gen, device="cuda").to(torch.bfloat16)
            got = im.int8_matmul_stacked_cuda(x, qt["q"], qt["scale"], 1)
            err = check_w16(torch, f"tp int8_matmul_stacked {name} K={K} N={N}", got,
                            im.int8_matmul_stacked_plain(x, qt["q"], qt["scale"], 1), f"B={B}")
            out["int8_matmul_stacked"][f"{name}_K{K}_N{N}_B{B}"] = dict(
                max_abs_err=err,
                ms=timer.ms(lambda: im.int8_matmul_stacked_cuda(x, qt["q"], qt["scale"], 1)))
        if name in ("qkv", "down"):
            x = torch.randn((419, K), generator=gen, device="cuda").to(torch.bfloat16)
            q1, s1 = qt["q"][1].contiguous(), qt["scale"][1].contiguous()
            err = check_w16(torch, f"tp int8_matmul {name} K={K} N={N}",
                            im.int8_matmul_cuda(x, q1, s1), im.int8_matmul_plain(x, q1, s1),
                            "B=419")
            out["int8_matmul"][f"{name}_K{K}_N{N}_B419"] = dict(
                max_abs_err=err, ms=timer.ms(lambda: im.int8_matmul_cuda(x, q1, s1)))
    out["int8_matmul_w8a8"] = tp_w8a8_kernels(torch, timer, gen, shapes)
    del timer
    log("tp shard kernels: " + json.dumps(out, default=float))
    return out


def tp_w8a8_kernels(torch, timer, gen, shards) -> dict:
    """tp_shard_kernels' W8A8 part: `shards` the projections' (K, N) at
    tp = 2; the whole projections are nano's. -> numbers by case."""
    from sonicscribe_tpu_torch.models.config import nano
    from sonicscribe_tpu_torch.ops import int8_matmul as im
    from sonicscribe_tpu_torch.ops.quant import quantize_tensor

    dec = nano().decoder
    whole = {"qkv": (dec.d_model, (dec.n_heads + 2 * dec.n_kv_heads) * dec.head_dim),
             "o": (dec.n_heads * dec.head_dim, dec.d_model),
             "gate_up": (dec.d_model, 2 * dec.ffn_hidden), "down": (dec.ffn_hidden, dec.d_model)}

    def recipe(x, qt, amax=None):
        """The plain version on CPU copies, layer 1, back on the card."""
        return im.int8_matmul_w8a8_plain(x.cpu(), qt["q"].cpu(), qt["scale"].cpu(), 1,
                                         None if amax is None else amax.cpu()).cuda()

    out = {}
    for kind, table in (("shard", shards), ("whole", whole)):
        for name, (K, N) in table.items():
            qt = quantize_tensor(torch.randn((2, K, N), generator=gen, device="cuda") * 0.05)
            for B in TP_W8A8_ROWS:
                x = torch.randn((B, K), generator=gen, device="cuda").to(torch.bfloat16)
                own = x.float().abs().amax(-1)
                case = f"{kind} {name} K={K} N={N} B={B}"
                if kind == "shard":
                    other = torch.randn((B, K), generator=gen, device="cuda").to(torch.bfloat16)
                    amax = torch.maximum(own, other.float().abs().amax(-1))
                    want = recipe(x, qt, amax)
                    got = [im.int8_matmul_w8a8_cuda(x, qt["q"], qt["scale"], 1, amax)]
                    for launch in (im._launch_w8a8_cluster, im._launch_w8a8_mma):
                        o, err = launch(x, qt["q"], qt["scale"], 1, row_amax=amax)
                        check(err == 0, f"tp W8A8 {case} {launch.__name__}: cudaError {err}")
                        got.append(o)
                    check(all(torch.equal(g, want) for g in got),
                          f"tp W8A8 {case}: with row_amax, not the plain version's bits "
                          f"(max err {max((g.float() - want.float()).abs().max().item() for g in got)})")
                    n_bytes = K * N + 4 * N + 2 * B * (K + N) + 4 * B
                    out[f"{name}_K{K}_N{N}_B{B}"] = dict(
                        max_abs_err=0.0, mma=im.w8a8_uses_mma(B, N),
                        ms=timer.ms(lambda: im.int8_matmul_w8a8_cuda(x, qt["q"], qt["scale"], 1,
                                                                     amax)),
                        ms_own_amax=timer.ms(lambda: im.int8_matmul_w8a8_cuda(
                            x, qt["q"], qt["scale"], 1)),
                        bound_ms=bound_ms(n_bytes, 2 * B * K * N, INT8_OPS_PER_S)[0])
                else:
                    got = im.int8_matmul_w8a8_cuda(x, qt["q"], qt["scale"], 1)
                    check(torch.equal(got, recipe(x, qt))
                          and torch.equal(got, im.int8_matmul_w8a8_cuda(x, qt["q"], qt["scale"],
                                                                        1, own)),
                          f"tp W8A8 {case}: without row_amax, not the plain version's bits "
                          f"or not the call's with each row's own max")
    log(f"tp W8A8: row_amax at the shard shapes and none at the whole, B {TP_W8A8_ROWS}: "
        f"bit-equal to the plain version")
    return out


def tp_tiny(torch, cards, mode: str = "native") -> tuple[dict, dict]:
    """tiny() f32 in quant mode `mode` over a (n/2) x 2 mesh of the cards
    (1 x 2 on two, 2 x 2 on four) against one engine on cuda:0 in the same
    mode, both warmed: TP_REQUESTS host
    requests at once and a drafted final give the single engine's tokens,
    TP_STREAMS ring streams its ring tokens; each rank's shards, pools and
    ring on its card with its share of the KV heads; each rank's
    decode-attention launches (its router's replays) and all-reduces above
    0; each follower's slots equal to its rank 0's. The launch counters
    are set to 0 just before the tp engine serves and read just after.
    -> (numbers, launches)."""
    from sonicscribe_tpu_torch.engine.batcher import BatchedEngine
    from sonicscribe_tpu_torch.engine.replicas import DataParallelEngine
    from sonicscribe_tpu_torch.ops import _build
    from sonicscribe_tpu_torch.parallel.mesh import make_mesh
    from sonicscribe_tpu_torch.vad.model import EnergyVad

    mesh = make_mesh(devices=cards, model_parallel=TP_DEGREE)
    single = BatchedEngine(tiny_transcriber(torch, "cuda", mode), EnergyVad(device="cuda"),
                           slots=8, max_decode_tokens=64, n_streams=8)
    engine = DataParallelEngine(tiny_transcriber(torch, "cuda", mode), EnergyVad(device="cuda"),
                                mesh, slots=8, max_decode_tokens=64, n_streams=2 * TP_STREAMS)
    nkv = single.cfg.decoder.n_kv_heads
    for row, rep in zip(mesh.devices, engine.replicas):
        for dev, eng in zip(row, rep._ranks):
            leaves = [t for k, v in eng.transcriber.params.items() if k != "tp"
                      for t in _tensors(v)]
            check(eng.device == dev and eng.ring.device == dev
                  and all(t.device == dev for p in eng.pools for t in p.state.values())
                  and all(t.device == dev for t in leaves)
                  and eng.long.state["k"].shape[3] == nkv // TP_DEGREE,
                  f"tp tiny: a rank's shards, pools or ring are not on {dev}")
    reqs = [(speech(0.8 + 0.3 * i, seed=140 + i), budget, ["gpu"] if i in (1, 4) else None)
            for i, budget in enumerate((8, 24, 15, 40, 21, 8, 30, 12))]
    audios = [speech(20 * CHUNK_SAMPLES / SR, seed=160 + i) for i in range(TP_STREAMS)]
    pcms = [(np.clip(a, -1, 1) * 32767).astype("<i2").tobytes() for a in audios]
    final = speech(2.5, seed=170)

    async def host(eng, draft=None):
        rs = await asyncio.gather(*[eng.transcribe(a, SR, max_new_tokens=b, hotwords=h)
                                    for a, b, h in reqs])
        drafted = await eng.transcribe(final, SR, max_new_tokens=40, draft_tokens=draft)
        return [r.tokens for r in rs], drafted.tokens

    async def ring(eng):
        streams = [eng.alloc_stream() for _ in audios]
        for s, p in zip(streams, pcms):
            for c in range(20):
                eng.ingest(s, c, p[c * 2048:(c + 1) * 2048])
        probs = await asyncio.gather(*[eng.vad_window_ring(s, 0) for s in streams])
        rs = await asyncio.gather(*[eng.transcribe_ring(s, 0, 20, max_new_tokens=24)
                                    for s in streams])
        for s in streams:
            eng.free_stream(s)
        return probs, [r.tokens for r in rs]

    try:
        single.warmup()
        w = engine.warmup()
        want, want_final = asyncio.run(host(single))
        want_probs, want_ring = asyncio.run(ring(single))
        launches0 = [[dict(e.router.stats["launches"]) for e in rep._ranks]
                     for rep in engine.replicas]
        on_run0 = sum(e.router.stats["captured_on_run"] for rep in engine.replicas
                      for e in rep._ranks)
        for d in cards:
            torch.cuda.synchronize(d)
        _build.reset_launch_counts()
        got, got_final = asyncio.run(host(engine, draft=np.asarray(want_final)))
        got_probs, got_ring = asyncio.run(ring(engine))
        for d in cards:
            torch.cuda.synchronize(d)
        counts = dict(_build.launch_counts)
        stats = engine.stats
        by_rank = [[{k: v - l0.get(k, 0) for k, v in e.router.stats["launches"].items()}
                    for e, l0 in zip(rep._ranks, l0s)]
                   for rep, l0s in zip(engine.replicas, launches0)]
        captured = sum(e.router.stats["captured_on_run"] for rep in engine.replicas
                       for e in rep._ranks) - on_run0
        follower_same = all(
            torch.equal(rep._ranks[0]._pool(p).state[f].cpu(), e._pool(p).state[f].cpu())
            for rep in engine.replicas for e in rep._ranks[1:] for p in ("short", "long")
            for f in ("out", "tok", "n", "len", "done", "status"))
    finally:
        single.shutdown()
        engine.shutdown()
        for rp in engine.replicas:
            rp.tp.close()
    check(all(np.array_equal(a, b) for a, b in zip(got, want)) and any(len(t) for t in want)
          and np.array_equal(got_final, want_final),
          f"tp tiny: tokens {got} + {got_final} differ from one engine's {want} + {want_final}")
    check(all(np.array_equal(a, b) for a, b in zip(got_ring, want_ring)),
          f"tp tiny: ring tokens {got_ring} differ from one engine's {want_ring}")
    check(np.allclose(got_probs, want_probs, atol=1e-6), f"tp tiny: ring VAD {got_probs}")
    check(follower_same, "tp tiny: a follower's slots differ from its rank 0's")
    check(captured == 0, f"tp tiny: {captured} graphs captured on the request path")
    attn = [[r.get("decode_attention", 0) for r in rep] for rep in by_rank]
    reduces = [[r.get("all_reduce", 0) for r in rep] for rep in by_rank]
    check(all(n > 0 for rep in attn for n in rep) and all(n > 0 for rep in reduces for n in rep),
          f"tp tiny: decode-attention launches {attn}, all-reduces {reduces} by rank")
    check(stats["verify_rounds"] > 0, "tp tiny: the drafted final took no verify round")
    check(mode != "int8-decoder-a8" or counts["int8_matmul_w8a8"] > 0,
          f"tp tiny {mode}: W8A8 never launched")
    log(f"tp tiny f32 {mode} over mesh {mesh.shape} on {[str(c) for c in cards]}: "
        f"{w['graphs']} graphs "
        f"warmed on rank 0 of each row; {TP_REQUESTS} host requests, a drafted final and "
        f"{TP_STREAMS} ring streams = one engine's tokens; followers' slots = rank 0's; "
        f"decode-attention launches {attn}, all-reduces {reduces} by row and rank")
    return dict(mesh=mesh.shape, graphs=w["graphs"], decode_attention=attn, all_reduces=reduces,
                verify_rounds=stats["verify_rounds"]), counts


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def events_ms(torch, fn, cards) -> float:
    """Device ms of one fn(): CUDA events on cards[0]'s stream around
    TP_STEP_REPS calls after a warm one, every card synchronized."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    for d in cards:
        torch.cuda.synchronize(d)
    a.record(torch.cuda.current_stream(cards[0]))
    for _ in range(TP_STEP_REPS):
        fn()
    b.record(torch.cuda.current_stream(cards[0]))
    for d in cards:
        torch.cuda.synchronize(d)
    return a.elapsed_time(b) / TP_STEP_REPS


def tp_steps(torch, cfg, params, trees, cards, group) -> dict:
    """Nano decode steps as CUDA graphs at TP_ROWS rows: one card's (on
    cards[0], the whole tree) and the pair's (each rank's shard on its
    card, through the group): the first replay's logits held against one
    card's (logits_agree), the device ms of a step each way, each rank's
    capture seconds, the all-reduces a replayed step launches on each rank
    (counted: 2 x n_layers sums, and under W8A8 decode as many maxima),
    and the device ms of the step's 2 x n_layers sums of [rows, d_model]
    alone (a graph of them); under W8A8 decode also that of its 2 x
    n_layers maxima of the rows' float32 max|x| alone."""
    from sonicscribe_tpu_torch.engine.exec_store import GraphRouter
    from sonicscribe_tpu_torch.models import glm_asr
    from sonicscribe_tpu_torch.models.config import tp_local
    from sonicscribe_tpu_torch.ops import _build

    local = tp_local(cfg, TP_DEGREE)
    single, routers = GraphRouter(cards[0]), [GraphRouter(d) for d in cards]
    n_reduce = 2 * cfg.decoder.n_layers
    a8 = cfg.decoder.act_int8_decode
    want_reduces = 2 * n_reduce if a8 else n_reduce

    def program(tree, c):
        def step(bufs):
            _, logits = glm_asr.decode_step(tree, c, {k: bufs[k] for k in ("k", "v", "len")},
                                            bufs["tok"])
            return {"logits": logits}
        return step

    def reduces(r, op="sum"):
        def program(bufs):
            for _ in range(n_reduce):
                group.all_reduce(r, bufs["x"], op=op)
            return {}
        return program

    out = {}
    for rows in TP_ROWS:
        whole, shards, tok = step_inputs(torch, cfg, rows, cards)
        bufs1 = dict(whole, tok=tok)
        bufs = [dict(c, tok=tok.to(d)) for c, d in zip(shards, cards)]
        key = ("decode", rows)
        single.prepare(key, program(params, cfg), bufs1, replay=False)
        group.run(lambda r: routers[r].prepare(key, program(trees[r], local), bufs[r],
                                               replay=False))
        want = single.run(key, None, bufs1)["logits"]
        got = group.run(lambda r: routers[r].run(key, None, bufs[r]))["logits"]
        for d in cards:
            torch.cuda.synchronize(d)
        agree = logits_agree(f"tp nano {rows} rows", got, want,
                             TP_A8_LOGIT_TOL if a8 else TP_LOGIT_TOL)
        before = _build.launch_counts["all_reduce"]
        group.run(lambda r: routers[r].run(key, None, bufs[r]))
        for d in cards:
            torch.cuda.synchronize(d)
        step_reduces = (_build.launch_counts["all_reduce"] - before) / TP_DEGREE
        check(step_reduces == want_reduces,
              f"tp nano {rows} rows: {step_reduces} all-reduces a step and rank, want "
              f"{want_reduces}")
        one_ms = events_ms(torch, lambda: single.run(key, None, bufs1), cards)
        tp_ms = events_ms(torch, lambda: group.run(lambda r: routers[r].run(key, None, bufs[r])),
                          cards)
        xs = [{"x": torch.zeros((rows, cfg.decoder.d_model), dtype=torch.bfloat16, device=d)}
              for d in cards]
        ar_key = ("all_reduce", rows)
        group.run(lambda r: routers[r].prepare(ar_key, reduces(r), xs[r], replay=False))
        ar_ms = events_ms(torch, lambda: group.run(lambda r: routers[r].run(ar_key, None, xs[r])),
                          cards)
        max_ms = None
        if a8:
            ms_ = [{"x": torch.zeros((rows,), dtype=torch.float32, device=d)} for d in cards]
            max_key = ("all_reduce_max", rows)
            group.run(lambda r: routers[r].prepare(max_key, reduces(r, "max"), ms_[r],
                                                   replay=False))
            max_ms = events_ms(
                torch, lambda: group.run(lambda r: routers[r].run(max_key, None, ms_[r])), cards)
        out[rows] = dict(agree, one_card_ms=one_ms, tp_ms=tp_ms, all_reduce_ms=ar_ms,
                         all_reduces=n_reduce, step_all_reduces=step_reduces,
                         max_reduce_ms=max_ms,
                         capture_s=[r.stats["capture_s"][key] for r in routers],
                         one_card_capture_s=single.stats["capture_s"][key])
        log(f"tp nano {'int8-decoder-a8' if a8 else 'bf16'} decode step, {rows} rows: one card "
            f"{one_ms:.3f} ms, tp=2 {tp_ms:.3f} ms ({step_reduces:.0f} all-reduces a step and "
            f"rank; {n_reduce} sums of [{rows}, {cfg.decoder.d_model}] alone {ar_ms:.3f} ms"
            + (f", {n_reduce} maxima of [{rows}] float32 alone {max_ms:.3f} ms" if a8 else "")
            + f"); logits {agree['max_abs_err']:.4f} from one card's (max "
            f"{agree['max_abs_logit']:.3f}), greedy token the same in "
            f"{agree['argmax_same']:.3f} of rows; capture {out[rows]['capture_s']} s by rank")
    return out


def tp_nano(torch, cards) -> tuple[dict, dict]:
    """Nano bf16 at full width over a pair of cards: each rank's resident
    weight GiB, tp_steps, then the dp x tp engine (1 x 2, fast-booted, its
    deferred keys dropped as in dp_load) serving the ~12 s request through
    the file path (serve_request: decode attention once per layer, step and
    rank), its wall beside phase 3's threaded one-card tokens. -> (numbers,
    the request's launches)."""
    from sonicscribe_tpu_torch.config import AppConfig
    from sonicscribe_tpu_torch.engine.replicas import DataParallelEngine
    from sonicscribe_tpu_torch.engine.transcriber import Transcriber
    from sonicscribe_tpu_torch.models.config import nano
    from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
    from sonicscribe_tpu_torch.models.weights import init_random
    from sonicscribe_tpu_torch.parallel.mesh import make_mesh, shard_params_tp
    from sonicscribe_tpu_torch.parallel.tp import TPGroup
    from sonicscribe_tpu_torch.vad.model import EnergyVad

    cfg, config = nano(), AppConfig()
    params = init_random(cfg, SEED, dtype=torch.bfloat16, device=cards[0])
    mesh = make_mesh(devices=cards, model_parallel=TP_DEGREE)
    group = TPGroup(cards)
    try:
        trees = group.attach(shard_params_tp(params, mesh, cfg), cfg)
        gib = dict(one_card=tree_gib(params),
                   ranks=[tree_gib({k: v for k, v in t.items() if k != "tp"}) for t in trees])
        log(f"tp nano bf16 weights: one card {gib['one_card']:.3f} GiB, by rank "
            f"{[round(g, 3) for g in gib['ranks']]} GiB")
        with torch.inference_mode():
            steps = tp_steps(torch, cfg, params, trees, cards, group)
        del trees
    finally:
        group.close()
    release_memory(torch)
    tr = Transcriber(cfg, params, ByteTokenizer(cfg), prefill_buckets=tuple(config.prefill_buckets))
    vad = EnergyVad(device=cards[0])
    engine = DataParallelEngine(tr, vad, mesh, slots=config.decode_slots,
                                max_decode_tokens=max(config.file_max_new_tokens,
                                                      config.final_max_tokens))
    try:
        boot = engine.warmup(budgets=GRID_BUDGETS, fast=True)
        rep = engine.replicas[0]
        rep._replay_queue.clear()
        rep._note_deferred()
        resident = [torch.cuda.memory_allocated(d) / 2**30 for d in cards]
        r = serve_request(torch, engine, vad, config, "12s tp", payloads()["12s"],
                          ranks=TP_DEGREE)
        one_card = THREADED_TOKENS.get(("native", "12s"))
        same = one_card is not None and len(one_card) == len(r["calls"]) and all(
            np.array_equal(c["tokens"], t) for c, t in zip(r["calls"], one_card))
        capture_s = [sum(e.router.stats["capture_s"].values()) for e in rep._ranks]
    finally:
        engine.shutdown()
        for rp in engine.replicas:
            rp.tp.close()
    log(f"tp nano bf16 12 s request on mesh {mesh.shape}: wall {r['wall']:.3f} s, RTF "
        f"{r['rtf']:.4f}, {r['tokens']} tokens, {r['tokens_per_s']:.1f} tokens/s; tokens "
        f"{'equal to' if same else 'differ from'} the one-card threaded engine's; fast boot "
        f"{boot['seconds']:.1f} s ({boot['graphs']} graphs on rank 0), capture seconds by rank "
        f"{[round(c, 1) for c in capture_s]}; resident {[round(g, 2) for g in resident]} GiB by card")
    return dict(weights_gib=gib, steps=steps, request=dict(
        wall=r["wall"], rtf=r["rtf"], tokens=r["tokens"], tokens_per_s=r["tokens_per_s"],
        steps=r["steps"], same_as_one_card=same), boot_s=boot["seconds"],
        boot_graphs=boot["graphs"], capture_s=capture_s, resident_gib=resident), r["counts"]


def tp_int8(torch, cards) -> tuple[dict, dict]:
    """Nano int8 (encoder and decoder W8A16, quantised whole, then cut) on a
    1 x 2 dp x tp engine, unwarmed (each key captured on first use): the
    ~3 s request through the file path, the stacked W8A16 kernel launched
    4 times per layer, step and rank on the shards, the flat one in
    prefill. -> (numbers, the request's launches)."""
    from sonicscribe_tpu_torch.config import AppConfig
    from sonicscribe_tpu_torch.engine.replicas import DataParallelEngine
    from sonicscribe_tpu_torch.engine.transcriber import Transcriber
    from sonicscribe_tpu_torch.models.config import nano
    from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
    from sonicscribe_tpu_torch.models.weights import init_random
    from sonicscribe_tpu_torch.ops.quant import quantize_params_int8
    from sonicscribe_tpu_torch.parallel.mesh import make_mesh
    from sonicscribe_tpu_torch.vad.model import EnergyVad

    cfg, config = nano(), AppConfig()
    params = quantize_params_int8(init_random(cfg, SEED, dtype=torch.bfloat16, device=cards[0]))
    tr = Transcriber(cfg, params, ByteTokenizer(cfg), prefill_buckets=tuple(config.prefill_buckets))
    vad = EnergyVad(device=cards[0])
    engine = DataParallelEngine(tr, vad, make_mesh(devices=cards, model_parallel=TP_DEGREE),
                                slots=4, max_decode_tokens=config.file_max_new_tokens)
    try:
        r = serve_request(torch, engine, vad, config, "3s tp int8", payloads()["3s"],
                          ranks=TP_DEGREE)
    finally:
        engine.shutdown()
        for rp in engine.replicas:
            rp.tp.close()
    c, L = r["counts"], cfg.decoder.n_layers
    check(c["int8_matmul_stacked"] == TP_DEGREE * 4 * L * r["steps"] and c["int8_matmul"] > 0,
          f"tp int8: {c['int8_matmul_stacked']} stacked W8A16 launches for {r['steps']} steps "
          f"x {L} layers x 4 x {TP_DEGREE} ranks, {c['int8_matmul']} flat")
    log(f"tp nano int8 3 s request: wall {r['wall']:.3f} s (graphs captured on the way), "
        f"{r['tokens']} tokens; launches { {k: v for k, v in c.items() if v} }")
    return dict(wall=r["wall"], tokens=r["tokens"], steps=r["steps"]), c


def tp_a8(torch, cards, native_steps: dict) -> tuple[dict, dict]:
    """Nano int8-decoder-a8 (decoder W8A16 prefill, W8A8 decode; the tree
    quantised whole, then cut) over a pair of cards: tp_steps (its
    captured step at TP_ROWS rows against its one-card step, beside
    `native_steps`, tp_nano's; 56 + 56 all-reduces a step), then a 1 x 2
    dp x tp engine, unwarmed (each key captured on first use): the ~3 s
    request through the file path, W8A8 launched 4 times per layer, step
    and rank (the row-parallel ones with the row maxima max-reduced over
    the ranks), the flat W8A16 in prefill; then its first segment again
    with its own tokens as the draft (verify rounds on both ranks; where
    the drafted tokens first part from the undrafted ones is printed, not
    checked: bf16 near-ties part the verify and decode programs, and
    tp_tiny holds -a8's drafted final token for token in f32). ->
    (numbers, the request's launches)."""
    from dataclasses import replace

    from sonicscribe_tpu_torch.config import AppConfig
    from sonicscribe_tpu_torch.engine.replicas import DataParallelEngine
    from sonicscribe_tpu_torch.engine.transcriber import Transcriber
    from sonicscribe_tpu_torch.models.config import nano
    from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
    from sonicscribe_tpu_torch.models.weights import init_random
    from sonicscribe_tpu_torch.ops.quant import quantize_params_int8
    from sonicscribe_tpu_torch.parallel.mesh import make_mesh, shard_params_tp
    from sonicscribe_tpu_torch.parallel.tp import TPGroup
    from sonicscribe_tpu_torch.vad.model import EnergyVad

    cfg, config = nano(), AppConfig()
    cfg = replace(cfg, decoder=replace(cfg.decoder, act_int8_decode=True))
    params = quantize_params_int8(init_random(cfg, SEED, dtype=torch.bfloat16, device=cards[0]),
                                  decoder_only=True)
    mesh = make_mesh(devices=cards, model_parallel=TP_DEGREE)
    group = TPGroup(cards)
    try:
        trees = group.attach(shard_params_tp(params, mesh, cfg), cfg)
        with torch.inference_mode():
            steps = tp_steps(torch, cfg, params, trees, cards, group)
        del trees
    finally:
        group.close()
    for rows, st in steps.items():
        st["native_tp_ms"] = native_steps[rows]["tp_ms"]
        log(f"tp nano int8-decoder-a8 step, {rows} rows: {st['tp_ms']:.3f} ms at tp = 2 against "
            f"native tp's {st['native_tp_ms']:.3f} ms (+{st['tp_ms'] - st['native_tp_ms']:.3f})")
    release_memory(torch)
    tr = Transcriber(cfg, params, ByteTokenizer(cfg), prefill_buckets=tuple(config.prefill_buckets))
    vad = EnergyVad(device=cards[0])
    engine = DataParallelEngine(tr, vad, mesh, slots=4, max_decode_tokens=config.file_max_new_tokens)
    # unwarmed, a tick captures the keys it meets, ~1 s a graph with NCCL in
    # it: the request's first tick took 50-73 s on the H100s, past the
    # watchdog's 60 s stack dump (a stall is still 600 s)
    engine.replicas[0].tick_stall_dump_s = 300.0
    try:
        r = serve_request(torch, engine, vad, config, "3s tp a8", payloads()["3s"],
                          ranks=TP_DEGREE)
        first = r["calls"][0]
        rounds0 = engine.stats["verify_rounds"]
        drafted = asyncio.run(engine.transcribe(first["audio"], first["sample_rate"],
                                                **first["kw"],
                                                draft_tokens=np.asarray(first["tokens"])))
        rounds = engine.stats["verify_rounds"] - rounds0
    finally:
        engine.shutdown()
        for rp in engine.replicas:
            rp.tp.close()
    c, L = r["counts"], cfg.decoder.n_layers
    check(c["int8_matmul_w8a8"] == TP_DEGREE * 4 * L * r["steps"] and c["int8_matmul"] > 0
          and c["int8_matmul_stacked"] == 0,
          f"tp a8: {c['int8_matmul_w8a8']} W8A8 launches for {r['steps']} steps x {L} layers x "
          f"4 x {TP_DEGREE} ranks, {c['int8_matmul']} flat W8A16, {c['int8_matmul_stacked']} "
          f"stacked")
    parted = first_divergence([list(drafted.tokens)], [list(first["tokens"])],
                              ("drafted", "undrafted"))
    check(rounds > 0 and len(drafted.tokens) > 0,
          f"tp a8: the drafted final took {rounds} verify rounds, {len(drafted.tokens)} tokens")
    log(f"tp nano int8-decoder-a8 3 s request: wall {r['wall']:.3f} s (graphs captured on the "
        f"way), {r['tokens']} tokens; launches { {k: v for k, v in c.items() if v} }; a drafted "
        f"final: {rounds} verify rounds, against the undrafted tokens: {parted}")
    return dict(steps=steps, wall=r["wall"], tokens=r["tokens"], steps_decoded=r["steps"],
                drafted_verify_rounds=rounds, drafted_vs_undrafted=parted), c


class W8A8Calls:
    """While active, every W8A8 product's x and row_amax (ops/quant.py's
    call of the entry, which it still makes: launches count as ever), kept
    by calling thread, so that the ranks' calls stay apart."""

    def __enter__(self):
        from sonicscribe_tpu_torch.ops import quant

        self.calls, self.quant, self.entry = {}, quant, quant.int8_matmul_w8a8

        def record(x, q, scale, layer, row_amax=None):
            self.calls.setdefault(threading.get_ident(), []).append(
                (x.clone(), None if row_amax is None else row_amax.clone()))
            return self.entry(x, q, scale, layer, row_amax)

        quant.int8_matmul_w8a8 = record
        return self

    def __exit__(self, *exc):
        self.quant.int8_matmul_w8a8 = self.entry


def tp_a8_codes(torch, whole_calls, rank_calls, n_layers: int) -> dict:
    """One -a8 step's W8A8 products, the whole tree's and each rank's, in
    order: at each row-parallel product (o and down, 2 a layer) both ranks'
    row_amax equal, and equal to the max of |x| over both ranks' shares
    side by side; each rank's int8 x (quantize_activations on CPU copies:
    the kernels give its bits, tp_w8a8_kernels) is the slice of the whole
    row's recipe, bit for bit; the column-parallel x is the same on both
    ranks. -> the products checked, and how many int8 codes of the pair's
    products differ from the whole tree's step (the flips TP_A8_LOGIT_TOL
    describes)."""
    from sonicscribe_tpu_torch.ops.int8_matmul import quantize_activations as quantize

    row_parallel = flips = values = 0
    check(len(whole_calls) == len(rank_calls[0]) == len(rank_calls[1]) == 4 * n_layers,
          f"tp a8: W8A8 products {len(whole_calls)}, {[len(c) for c in rank_calls]} by rank")
    for i, ((xs, _), (x0, a0), (x1, a1)) in enumerate(zip(whole_calls, *rank_calls)):
        if a0 is None:
            check(a1 is None and torch.equal(x0, x1), f"tp a8 product {i}: ranks' x differ")
            got = quantize(x0.cpu())[0]
        else:
            row_parallel += 1
            x = torch.cat([x0, x1], dim=-1).cpu()
            check(torch.equal(a0, a1) and torch.equal(a0.cpu(), x.float().abs().amax(-1)),
                  f"tp a8 product {i}: row_amax is not the max over both shares")
            got, K = quantize(x)[0], x0.shape[-1]
            for r, (xr, ar) in enumerate(((x0, a0), (x1, a1))):
                check(torch.equal(quantize(xr.cpu(), ar.cpu())[0], got[:, r * K:(r + 1) * K]),
                      f"tp a8 product {i}: rank {r}'s int8 x is not the whole row's slice")
        want = quantize(xs.cpu())[0]
        flips += int((got != want).sum())
        values += want.numel()
    check(row_parallel == 2 * n_layers, f"tp a8: {row_parallel} row-parallel products")
    return dict(row_parallel=row_parallel, codes=values, codes_flipped=flips)


def tp_one_card(torch) -> tuple[dict, dict]:
    """One card: both ranks' shards of one nano decode step at 32 rows on
    cuda:0, natively, in int8-decoder (W8A16) and in int8-decoder-a8
    (W8A8, each row-parallel product's row maxima taken over both ranks
    first), each rank on its thread and the partial sums added in rank
    order (OneCardPair), held against the card's whole-tree step
    (logits_agree); decode attention once per layer and rank, the stacked
    W8A16 or the W8A8 kernel 4 times, and under -a8 2 max-reduces a layer
    beside the 2 sums. -a8 runs once more on float32 weights and cache
    ("int8-decoder-a8 float32": one rounding difference there is the
    partial sums' order alone), and each -a8 whole-tree step is also set
    beside the native one of its dtype ("a8_vs_native", max |diff| over
    max|native logits|): the two figures TP_A8_LOGIT_TOL rests on. ->
    (numbers, the steps' launches)."""
    from dataclasses import replace

    from sonicscribe_tpu_torch.models import glm_asr
    from sonicscribe_tpu_torch.models.config import nano, tp_local
    from sonicscribe_tpu_torch.models.weights import init_random
    from sonicscribe_tpu_torch.ops import _build
    from sonicscribe_tpu_torch.ops.quant import quantize_params_int8

    L = nano().decoder.n_layers
    cards = [torch.device("cuda", 0)] * TP_DEGREE
    out, counts, native = {}, {}, {}
    for mode in ("native", "int8-decoder", "int8-decoder-a8", "int8-decoder-a8 float32"):
        a8 = mode.startswith("int8-decoder-a8")
        dtype = torch.float32 if mode.endswith("float32") else torch.bfloat16
        if mode in ("native", "int8-decoder-a8 float32"):
            params = init_random(nano(), SEED, dtype=dtype, device="cuda")
        cfg = nano()
        if a8:
            cfg = replace(cfg, decoder=replace(cfg.decoder, act_int8_decode=True))
        local = tp_local(cfg, TP_DEGREE)
        tree = params if mode == "native" else quantize_params_int8(params, decoder_only=True)
        pair = OneCardPair(torch)
        trees = tp_trees(torch, tree, cfg, cards, pair)
        whole, shards, tok = step_inputs(torch, cfg, TP_ROWS[-1], cards)
        for cache in (whole, *shards):
            cache["k"], cache["v"] = cache["k"].to(dtype), cache["v"].to(dtype)
        idents = [None] * TP_DEGREE

        def rank_step(r):
            idents[r] = threading.get_ident()
            return glm_asr.decode_step(trees[r], local, shards[r], tok)[1]

        with W8A8Calls() as rec:
            with torch.inference_mode():
                if mode == "int8-decoder-a8 float32":  # the float32 native step beside it
                    native[dtype] = glm_asr.decode_step(
                        params, nano(), {k: v.clone() for k, v in whole.items()}, tok)[1]
                want = glm_asr.decode_step(tree, cfg, whole, tok)[1]
            torch.cuda.synchronize()
            if mode == "native":
                native[dtype] = want
            whole_calls = rec.calls.pop(threading.get_ident(), [])
            _build.reset_launch_counts()
            got = pair.run(rank_step)
            torch.cuda.synchronize()
            c = dict(_build.launch_counts)
        check(torch.equal(got[0], got[1]), f"tp one card {mode}: the ranks' logits differ")
        check(c["decode_attention"] == TP_DEGREE * L
              and c["int8_matmul_stacked"] == (TP_DEGREE * 4 * L if mode == "int8-decoder" else 0)
              and c["int8_matmul_w8a8"] == (TP_DEGREE * 4 * L if a8 else 0),
              f"tp one card {mode}: launches {c}")
        check(pair.ops == [{"sum": 2 * L, "max": 2 * L if a8 else 0}] * TP_DEGREE,
              f"tp one card {mode}: reduces by rank {pair.ops}")
        out[mode] = dict(logits_agree(f"tp one card {mode}", got[0], want,
                                      TP_A8_LOGIT_TOL if a8 else TP_LOGIT_TOL),
                         reduces=pair.ops[0])
        if a8:
            out[mode].update(tp_a8_codes(torch, whole_calls,
                                         [rec.calls[i] for i in idents], L))
            ref = native[dtype].float()
            out[mode]["a8_vs_native"] = ((want.float() - ref).abs().max()
                                         / ref.abs().max()).item()
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        del trees, tree, whole, shards, whole_calls, rec
    del params, native
    log(f"tp one card: both ranks' shards of a nano decode step at {TP_ROWS[-1]} rows on cuda:0, "
        f"partials summed in rank order: logits against the whole tree's {json.dumps(out)}; "
        f"the engine leg (NCCL, CUDA graphs, the dp x tp engine) needs two cards")
    return out, counts


def tp_phase(torch) -> dict:
    """Tensor parallelism. The card count picks the leg: two cards or more
    run the engine leg (tp_tiny on a (n/2) x 2 mesh of up to four cards,
    tp_nano, tp_int8 and tp_a8 on the first two), one card the one-card leg
    (tp_one_card); both hold the shard shapes' kernels against their plain
    versions (tp_shard_kernels). -> numbers, with the launches of the tp
    runs ("launches")."""
    n = torch.cuda.device_count()
    leg = "engine" if n >= TP_DEGREE else "one card"
    if leg == "engine":  # the multi-card machine's own, read there
        log("tp cards: " + "; ".join(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()))
    log(f"tp: {n} card(s) present: the {leg} leg")
    out = dict(leg=leg, cards=n, shard_kernels=tp_shard_kernels(torch))
    launches: dict = {}
    if leg == "engine":
        cards = [torch.device("cuda", i) for i in range(4 if n >= 4 else TP_DEGREE)]
        parts = {"tiny": tp_tiny(torch, cards)}
        release_memory(torch)
        parts["tiny_a8"] = tp_tiny(torch, cards, "int8-decoder-a8")
        release_memory(torch)
        parts["nano"] = tp_nano(torch, cards[:TP_DEGREE])
        release_memory(torch)
        parts["int8"] = tp_int8(torch, cards[:TP_DEGREE])
        release_memory(torch)
        parts["a8"] = tp_a8(torch, cards[:TP_DEGREE], parts["nano"][0]["steps"])
    else:
        parts = {"one_card": tp_one_card(torch)}
    for name, (numbers, counts) in parts.items():
        out[name] = numbers
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = {k: v for k, v in launches.items() if v}
    ran = ("decode_attention", "int8_matmul_stacked", "int8_matmul_w8a8") + (
        ("verify_attention", "log_mel", "int8_matmul", "all_reduce") if leg == "engine" else ())
    for name in ran:
        check(launches.get(name, 0) > 0, f"tp: {name} never launched on the {leg} leg")
    return out


_PREWARM_CHILD = r"""
import asyncio, json, sys
import numpy as np
from sonicscribe_tpu_torch import native
from sonicscribe_tpu_torch.ops import _build
from sonicscribe_tpu_torch.serve.runtime import build_runtime
engine, _vad, _info = build_runtime("tiny-random")
native.load()
rng = np.random.default_rng(0)
r = asyncio.run(engine.transcribe((0.1 * rng.standard_normal(24000)).astype(np.float32), 16000,
                                  max_new_tokens=8))
engine.shutdown()
print(json.dumps({"saves": _build.library_counts["built"] + native.library_counts["built"],
                  "loads": _build.library_counts["loaded"] + native.library_counts["loaded"],
                  "tokens": len(r.tokens), "launches": dict(_build.launch_counts)}))
"""


def prewarm_phase(torch) -> dict:
    """tools/prewarm.py --model tiny-random --out <tmp>: every kernel
    library and the native one copied from what this run built (the same
    bytes), nothing built; then a child process with SONIC_KERNEL_DIR on
    that directory serves one tiny request on the card: it must build
    nothing (saves 0), load the libraries it ran prebuilt, and launch the
    log-mel and decode-attention kernels. -> numbers."""
    import filecmp
    import re
    import shutil
    import tempfile

    from sonicscribe_tpu_torch import native
    from sonicscribe_tpu_torch.ops import _build

    root = os.path.dirname(os.path.abspath(__file__))
    out = tempfile.mkdtemp(prefix="sonic_prewarm_")
    native.build()  # the checkout's native library, as the stream phases built it
    try:
        env = {k: v for k, v in os.environ.items() if k != _build.KERNEL_DIR_ENV}
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "sonicscribe_tpu_torch.tools.prewarm",
                            "--model", "tiny-random", "--out", out], capture_output=True,
                           text=True, timeout=600, cwd=root, env=env)
        prewarm_s = time.perf_counter() - t0
        check(r.returncode == 0, f"prewarm exited {r.returncode}: {r.stderr[-2000:]}")
        line = next(ln for ln in r.stdout.splitlines() if ln.startswith("prewarm done"))
        saves = int(re.search(r"saves=(\d+)", line).group(1))
        libs = [os.path.basename(_build.library_path(k)) for k in _build.KERNELS]
        same = [filecmp.cmp(os.path.join(_build.BUILD_DIR, name),
                            os.path.join(out, "kernels", name), shallow=False) for name in libs]
        nat = os.path.basename(native.lib_path())
        check(saves == len(libs) + 1 and all(same)
              and filecmp.cmp(native.BUILD_DIR / nat, os.path.join(out, "native", nat),
                              shallow=False),
              f"prewarm: {line!r}; the kernel libraries copied as built: {same}")
        t0 = time.perf_counter()
        c = subprocess.run([sys.executable, "-c", _PREWARM_CHILD], capture_output=True,
                           text=True, timeout=600, cwd=root,
                           env=dict(env, **{_build.KERNEL_DIR_ENV: out}))
        child_s = time.perf_counter() - t0
        check(c.returncode == 0, f"prewarm restart exited {c.returncode}: {c.stderr[-2000:]}")
        got = json.loads(c.stdout.strip().splitlines()[-1])
        check(got["saves"] == 0 and got["loads"] >= 3 and got["tokens"] > 0
              and got["launches"]["log_mel"] > 0 and got["launches"]["decode_attention"] > 0,
              f"prewarm restart: {got}")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    log(f"prewarm: {line}; the restart on SONIC_KERNEL_DIR built {got['saves']}, loaded "
        f"{got['loads']} prebuilt, {got['tokens']} tokens; prewarm {prewarm_s:.1f} s, restart "
        f"process {child_s:.1f} s")
    return dict(line=line, prewarm_s=prewarm_s, restart_s=child_s, restart=got)


def resilience_phase(torch) -> dict:
    """tools/bench_resilience.py on the card: wait_for_device with its
    default probe (a child interpreter's round trip on the card) answers
    at the first probe, none hung; run_phase on a child that writes JSON
    gives "ok" with its result, on one that exits 7 "crashed" with rc 7.
    -> the statuses and seconds."""
    import tempfile

    from sonicscribe_tpu_torch.tools import bench_resilience as br

    waited = br.wait_for_device(attempts=1)
    check(waited["ok"] and waited["hung_probes"] == 0
          and [a["status"] for a in waited["attempts"]] == ["ok"],
          f"resilience: the card's probe did not answer: {waited}")
    with tempfile.TemporaryDirectory(prefix="sonic-resilience-") as d:
        out = os.path.join(d, "phase.json")
        ok = br.run_phase([sys.executable, "-c",
                           "import json, sys; json.dump({'value': 1}, open(sys.argv[1], 'w'))",
                           out], out, timeout_s=60)
        crashed = br.run_phase([sys.executable, "-c", "import sys; sys.exit(7)"], out,
                               timeout_s=60)
    check(ok["status"] == "ok" and ok["result"] == {"value": 1},
          f"resilience: the JSON child gave {ok}")
    check(crashed["status"] == "crashed" and crashed["rc"] == 7,
          f"resilience: the failing child gave {crashed}")
    result = dict(probe_s=waited["attempts"][0]["took_s"], waited_s=waited["waited_s"],
                  hung_probes=waited["hung_probes"], ok_phase=ok["status"],
                  ok_phase_s=ok["took_s"], crashed_phase=crashed["status"],
                  crashed_rc=crashed["rc"])
    log("resilience " + json.dumps(result))
    return result


def release_memory(torch) -> None:
    """Free what earlier phases left on the card, cuBLAS's per-stream
    workspaces included, so that the resident and peak memory read next
    are the next runtime's alone. A CUDA graph captured before it and
    replayed after it writes into a freed workspace: call it only when no
    graph of a live transcriber will be replayed again."""
    torch._C._cuda_clearCublasWorkspaces()
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    from sonicscribe_tpu_torch.device import resolve_device
    from sonicscribe_tpu_torch.ops import _build

    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    log(smi[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()

    def mark(phase: str) -> None:  # where the script's time goes
        log(f"[{time.perf_counter() - t0:.1f} s] {phase} done")

    reports = _build.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s for {sorted(reports) or 'none (cached)'}")
    for name, report in reports.items():
        regs = [ln.strip() for ln in report.splitlines() if "registers" in ln]
        log(f"  {name}: {'; '.join(regs)}")

    weight_scale_phase(torch)
    timer = Timer(torch)
    attn_err, attn_row, mel_err, mel_row = kernel_phase(torch, timer)
    verify = verify_kernel_phase(torch, timer)
    int8_errs, int8_rows = int8_kernel_phase(torch, timer)
    int4_errs, int4_rows, int4_launches = int4_kernel_phase(torch, timer)
    batched_rows = batched_kernel_phase(torch, timer)
    del timer
    mark("kernel phases")
    bench_launches, slice_steps = bench_phase(torch)
    int4_launches.update(bench_launches)
    int8_rows["int8_matmul_stacked"]["slice_table_steps"] = slice_steps
    release_memory(torch)
    mark("bench sweeps")
    micro_phase(torch)
    release_memory(torch)
    mark("micro")

    engine, launches, native = main_path_phase(torch)
    mark("main path")
    try:
        stream = stream_phase(torch, engine, native["grid"])
        mark("stream")
        reference_phase(torch, engine)
        mark("reference")
    finally:
        engine.shutdown()
    del engine
    captured = {"native": native}
    for mode in INT8_MODES:
        release_memory(torch)
        counts, captured[mode] = int8_main_path_phase(torch, mode)
        for name in (*int8_errs, "int8_matmul_mma", "int8_matmul_w8a8_mma"):
            launches[name] = launches.get(name, 0) + counts[name]
        mark(f"main path {mode}")
    for mode in INT8_MODES:
        tiny_tokens_phase(torch, mode)
    tiny_batched_phase(torch)
    mark("tiny references")
    silero = silero_phase(torch)
    mark("silero")
    batched, batched_launches = {}, {}
    for mode in BATCHED_MODES:
        release_memory(torch)
        counts, batched[mode] = batched_phase(torch, mode)
        for name, n in counts.items():
            batched_launches[name] = batched_launches.get(name, 0) + n
        mark(f"batched {mode}")
    release_memory(torch)
    dp = dp_phase(torch)
    mark("dp")
    release_memory(torch)
    tp = tp_phase(torch)
    mark(f"tp ({tp['leg']} leg)")
    prewarmed = prewarm_phase(torch)
    mark("prewarm")
    resilience_phase(torch)
    mark("resilience")
    log("captured " + json.dumps(captured, default=float))
    log("stream " + json.dumps(stream, default=float))
    log("batched " + json.dumps(batched, default=float))
    log("silero " + json.dumps(silero, default=float))
    log("dp " + json.dumps(dp, default=float))
    log("tp " + json.dumps(tp, default=float))
    log("prewarm " + json.dumps(prewarmed, default=float))
    for name in ("decode_attention", "verify_attention", "log_mel", "int8_matmul",
                 "int8_matmul_w8a8", "int8_matmul_w8a8_mma"):
        check(batched_launches.get(name, 0) > 0, f"{name} never launched on the batched paths")
    check(batched_launches["int8_matmul_w8a8"] > batched_launches["int8_matmul_w8a8_mma"],
          "W8A8's cluster design never ran on the batched paths")

    kernels = [
        dict(name="decode_attention", route="cuda",
             source="sonicscribe_tpu_torch/csrc/decode_attention.cu",
             replaces="sonicscribe_tpu/ops/decode_attention.py:34", path="serve",
             launches=launches["decode_attention"],
             stream_launches=stream["launches"].get("decode_attention", 0),
             max_abs_err=attn_err, **attn_row),
        # no Pallas kernel: the JAX package's verify_step leaves its attention to XLA
        dict(name="verify_attention", route="cuda",
             source="sonicscribe_tpu_torch/csrc/decode_attention.cu",
             replaces="sonicscribe_tpu/models/glm_asr.py:568", path="batched drafts",
             launches=sum(b["drafts"]["launches"].get("verify_attention", 0)
                          for b in batched.values()),
             mma_launches=sum(b["drafts"]["launches"].get("verify_attention_mma", 0)
                              for b in batched.values()),
             stream_launches=sum(b["streams"]["launches"].get("verify_attention", 0)
                                 for b in batched.values()),
             max_abs_err=verify["max_abs_err"], **verify["main"],
             shapes=verify["shapes"]),
        dict(name="log_mel", route="cuda",
             source="sonicscribe_tpu_torch/csrc/log_mel.cu",
             replaces="sonicscribe_tpu/ops/mel_pallas.py:53", path="serve",
             launches=launches["log_mel"], stream_launches=stream["launches"].get("log_mel", 0),
             max_abs_err=mel_err, **mel_row),
        dict(name="int8_matmul", route="cuda",
             source="sonicscribe_tpu_torch/csrc/int8_matmul.cu",
             replaces="sonicscribe_tpu/ops/int8_pallas.py:39", path="serve",
             launches=launches["int8_matmul"], mma_launches=launches["int8_matmul_mma"],
             max_abs_err=int8_errs["int8_matmul"], **int8_rows["int8_matmul"]),
        dict(name="int8_matmul_stacked", route="cuda",
             source="sonicscribe_tpu_torch/csrc/int8_matmul.cu",
             replaces="sonicscribe_tpu/ops/int8_pallas.py:114", path="serve",
             launches=launches["int8_matmul_stacked"],
             max_abs_err=int8_errs["int8_matmul_stacked"], **int8_rows["int8_matmul_stacked"]),
        # no Pallas kernel: the JAX package leaves matmul_w8a8 to XLA
        dict(name="int8_matmul_w8a8", route="cuda",
             source="sonicscribe_tpu_torch/csrc/int8_matmul.cu",
             replaces="sonicscribe_tpu/ops/quant.py:72", path="serve",
             launches=launches["int8_matmul_w8a8"], mma_launches=launches["int8_matmul_w8a8_mma"],
             max_abs_err=int8_errs["int8_matmul_w8a8"],
             **int8_rows["int8_matmul_w8a8"]),
    ] + [
        dict(name=name, route="cuda", source="sonicscribe_tpu_torch/csrc/int4_matmul.cu",
             replaces=f"sonicscribe_tpu/ops/int4_pallas.py:{line}", path=path,
             launches=int4_launches[name], max_abs_err=int4_errs[name], **int4_rows[name])
        for name, (line, path) in INT4_ENTRIES.items()
    ]
    # the int4 launches that took the tensor cores on each entry's path (the
    # timed runs count flat and stacked together)
    kernels[-4]["mma_launches"] = int4_launches["int4_matmul_w4a16_mma"]
    kernels[-3]["mma_launches"] = int4_launches["int4_matmul_stacked_mma"]
    kernels[-2]["mma_launches"] = int4_launches["int4_matmul_w4a8_mma"]
    kernels[-1]["mma_launches"] = int4_launches["int4_matmul_w4a8_stacked_mma"]
    load_launches = batched["native"]["load"]["launches"]
    dp_launches = dp["load"]["launches"]
    for k in kernels:
        k["load_launches"] = load_launches.get(k["name"], 0)
        k["dp_launches"] = dp_launches.get(k["name"], 0)
        k["tp_launches"] = tp["launches"].get(k["name"], 0)
        k["batched_launches"] = batched_launches.get(k["name"], 0)
        if k["name"] in batched_rows:
            k["batched_shapes"] = batched_rows[k["name"]]
    w8a8 = next(k for k in kernels if k["name"] == "int8_matmul_w8a8")
    w8a8["batched_mma_launches"] = batched_launches.get("int8_matmul_w8a8_mma", 0)
    # with a given row_amax at the tp = 2 shard shapes (tp_w8a8_kernels)
    w8a8["tp_shapes"] = tp["shard_kernels"]["int8_matmul_w8a8"]
    # decode attention's launches in the fused runs of the dual A/B (two a
    # dual step and layer, one per pool), a part of its batched_launches
    kernels[0]["dual_launches"] = batched["native"]["dual"]["launches"][1]["decode_attention"]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} never launched on the main path")
        check(k.get("stream_launches", 1) > 0, f"{k['name']} never launched on the stream")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
