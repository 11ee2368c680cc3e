"""Port parity for the continuous batcher on the CPU: the port's
BatchedEngine (engine/batcher.py) against the JAX package's BatchedEngine
and the port's own sequential Transcriber, on the same scaled tiny() f32
tree, token for token; the host VAD batch, the interim stagger, shutdown;
and serving: build_runtime's default engine, the /transcribe/file NDJSON
and a /ws/audio session on the batched engine against the JAX app's."""

import asyncio
import json
import time

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import Tracked, settle
from sonicscribe_tpu.audio.wav import write_wav
from sonicscribe_tpu.config import AppConfig as AppConfigJax
from sonicscribe_tpu.engine.batcher import BatchedEngine as BatchedEngineJax
from sonicscribe_tpu.engine.batcher import _RingTranscribeReq as RingReqJax
from sonicscribe_tpu.engine.transcriber import Transcriber as TranscriberJax
from sonicscribe_tpu.models import tiny as tiny_jax
from sonicscribe_tpu.models.glm_asr import init_params
from sonicscribe_tpu.models.tokenizer import ByteTokenizer as ByteTokenizerJax
from sonicscribe_tpu.serve.app import build_app as build_app_jax
from sonicscribe_tpu.serve.session import StreamSession as StreamSessionJax
from sonicscribe_tpu.vad.model import EnergyVad as EnergyVadJax
from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.engine import spans
from sonicscribe_tpu_torch.engine.batcher import BatchedEngine, _RingTranscribeReq
from sonicscribe_tpu_torch.engine.spans import tick_phases
from sonicscribe_tpu_torch.engine.transcriber import Transcriber
from sonicscribe_tpu_torch.models import tiny
from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
from sonicscribe_tpu_torch.models.weights import params_from_jax
from sonicscribe_tpu_torch.serve import app as app_module
from sonicscribe_tpu_torch.serve.app import build_app
from sonicscribe_tpu_torch.serve.engine_async import ThreadedEngine
from sonicscribe_tpu_torch.serve.runtime import build_runtime
from sonicscribe_tpu_torch.serve.session import StreamSession
from sonicscribe_tpu_torch.vad.model import EnergyVad

SR = 16000
CHUNK = 1024
VAD_TOL = 1e-6  # probability: float32 band energies from another matmul shape


def _audio(seconds, f=300.0, seed=None):
    t = np.arange(int(SR * seconds)) / SR
    x = 0.3 * np.sin(2 * np.pi * f * t)
    if seed is not None:
        x = x + 0.01 * np.random.default_rng(seed).standard_normal(len(t))
    return x.astype(np.float32)


def _speech(sec, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * sec)) / SR
    env = 0.5 * (1 + np.sin(2 * np.pi * 3 * t))
    x = 0.25 * env * sum(np.sin(2 * np.pi * f * t) for f in (200, 700, 1500, 2600))
    return (x + 0.002 * rng.standard_normal(len(t))).astype(np.float32)


def _silence(sec, seed=1):
    return (0.0006 * np.random.default_rng(seed).standard_normal(int(SR * sec))).astype(
        np.float32)


def _pcm(audio) -> bytes:
    return (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()


def _transcribers(buckets=(64, 128), strength=3.0):
    """(JAX Transcriber, port Transcriber) on tiny() f32 from PRNGKey(0), the
    tree x4 so that the random model's tokens vary, carried over bit-exact."""
    params_j = jax.tree.map(lambda x: x * 4.0,
                            init_params(tiny_jax(), jax.random.PRNGKey(0), dtype=jnp.float32))
    tr_j = TranscriberJax(tiny_jax(), params_j, ByteTokenizerJax(tiny_jax()),
                          prefill_buckets=buckets, hotword_bias_strength=strength)
    params = params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")
    tr = Transcriber(tiny(), params, ByteTokenizer(tiny()), prefill_buckets=buckets,
                     hotword_bias_strength=strength)
    return tr_j, tr


@pytest.fixture(scope="module")
def stack():
    return _transcribers()


def _engines(stack, **kw):
    """(JAX BatchedEngine, port BatchedEngine) over the stack's
    transcribers, speculative finals on in both (their default)."""
    tr_j, tr = stack
    return BatchedEngineJax(tr_j, EnergyVadJax(), **kw), BatchedEngine(tr, EnergyVad(device="cpu"),
                                                                       **kw)


def _both(stack, run, **kw):
    """run(engine) on the JAX engine, then on the port's, each in its own
    event loop, shut down after. -> (JAX result, port result)."""
    out = []
    for eng in _engines(stack, **kw):
        async def go(eng=eng):
            try:
                return await run(eng)
            finally:
                eng.shutdown()
        out.append(asyncio.run(go()))
    return out


def _assert_tokens(got, want, label):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{label} {i}")


def test_single_request_parity(stack):
    _, tr = stack
    audio = _audio(0.5, seed=1)
    golden = tr.transcribe(audio, SR, max_new_tokens=10)

    async def run(eng):
        return await eng.transcribe(audio, SR, max_new_tokens=10)

    want, got = _both(stack, run, slots=4, max_decode_tokens=32, n_streams=4)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.tokens, golden.tokens)
    assert got.text == want.text == golden.text and len(got.tokens) == 10


def test_concurrent_requests_match_jax_and_sequential(stack):
    """Five requests at once, of different lengths, budgets and hotwords, on
    4 long slots (one queues): the JAX engine's tokens and the port's
    sequential Transcriber's."""
    _, tr = stack
    reqs = [(_audio(0.3 + 0.3 * i, f=200 + 60 * i, seed=i), budget, hot)
            for i, (budget, hot) in enumerate([(4, None), (24, ["jax"]), (8, None),
                                               (30, ["tpu", "z"]), (20, None)])]
    golden = [tr.transcribe(a, SR, max_new_tokens=b, hotwords=h).tokens for a, b, h in reqs]

    async def run(eng):
        rs = await asyncio.gather(*[eng.transcribe(a, SR, max_new_tokens=b, hotwords=h)
                                    for a, b, h in reqs])
        return [r.tokens for r in rs], dict(eng.stats)

    (want, stats_j), (got, stats) = _both(stack, run, slots=4, max_decode_tokens=32,
                                          n_streams=4)
    _assert_tokens(got, want, "request")
    _assert_tokens(got, golden, "request vs sequential")
    assert stats["prefills"] == stats_j["prefills"] == 5
    # emitted tokens: up to the budget, or to EOS with the EOS
    emitted = sum(len(g) + (len(g) < b) for g, (_, b, _) in zip(golden, reqs))
    assert stats["requests"] == 5 and stats["tokens"] == emitted


def test_final_wave_admits_as_one_group(stack):
    """Eight ring finals at the largest chunk bucket, each stream's own
    audio ingested first, admit through one B = 8 prefill program when that
    size is registered (as JAX's warmup registers it): the same group sizes
    and tokens as JAX."""
    waves = [_pcm(_speech(20 * CHUNK / SR, seed=60 + s)) for s in range(8)]

    async def run(eng):
        big_cb, sb0 = max(eng.chunk_buckets), eng.suffix_buckets[0]
        eng.long.compiled_ring_prefill.update({(big_cb, sb0, 4), (big_cb, sb0, 8)})
        await eng.start()
        loop, futs = asyncio.get_running_loop(), []
        streams = [eng.alloc_stream() for _ in range(8)]
        for s in streams:
            for c in range(big_cb):
                eng.ingest(s, c, waves[s][2 * CHUNK * c : 2 * CHUNK * (c + 1)])
        req = RingReqJax if isinstance(eng, BatchedEngineJax) else _RingTranscribeReq
        for s in streams:
            fut = loop.create_future()
            await eng._ring_requests.put(req(s, 0, big_cb, 20, None, 1.0, fut,
                                             time.perf_counter()))
            futs.append(fut)
        eng._wake.set()
        results = await asyncio.gather(*futs)
        return [r.tokens for r in results], dict(eng.stats)

    (want, stats_j), (got, stats) = _both(stack, run, slots=8, max_decode_tokens=64,
                                          n_streams=8)
    _assert_tokens(got, want, "stream")
    assert stats["prefills"] == stats_j["prefills"] == 8
    assert stats["prefill_programs"] == stats_j["prefill_programs"] == 1
    assert len({tuple(t) for t in got}) > 1  # each stream decoded its own audio


def test_sequential_waves_no_stale_reap(stack):
    """A slot freed and admitted again one tick later is not finished by
    its previous request's parked status."""
    _, tr = stack
    wave_a = [_audio(0.3, f=200 + 40 * i, seed=10 + i) for i in range(4)]
    wave_b = [_audio(0.45, f=500 + 35 * i, seed=20 + i) for i in range(4)]
    golden_b = [tr.transcribe(a, SR, max_new_tokens=8).tokens for a in wave_b]

    async def run(eng):
        await asyncio.gather(*[eng.transcribe(a, SR, max_new_tokens=8) for a in wave_a])
        rb = await asyncio.gather(*[eng.transcribe(a, SR, max_new_tokens=8) for a in wave_b])
        return [r.tokens for r in rb]

    want, got = _both(stack, run, slots=4, max_decode_tokens=32, n_streams=4)
    _assert_tokens(got, want, "wave-2 request")
    _assert_tokens(got, golden_b, "wave-2 request vs sequential")


def test_rows_prefix_decode_parity(stack):
    """Occupied-prefix decode: _pick_rows takes the smallest registered
    rung covering the active slots; a small wave decodes on rows 1 or 4, a
    full wave on the full pool, with the tokens of JAX and of the
    sequential Transcriber."""
    _, tr = stack
    small = [_audio(0.3, f=220 + 50 * i, seed=30 + i) for i in range(2)]
    big = [_audio(0.4, f=400 + 30 * i, seed=40 + i) for i in range(8)]
    golden = [tr.transcribe(a, SR, max_new_tokens=20).tokens for a in small + big]

    async def run(eng):
        assert eng.long.rows_ladder == (1, 4)
        eng.long.compiled_decode |= {(8, 1), (8, 4), (8, None)}
        for i, s in enumerate(eng.long.slots):
            s.active = i == 0
        picks = [eng._pick_rows(eng.long, 8), eng._pick_rows(eng.long, 2)]
        eng.long.slots[2].active = True
        picks.append(eng._pick_rows(eng.long, 8))
        eng.long.slots[5].active = True
        picks.append(eng._pick_rows(eng.long, 8))
        for s in eng.long.slots:
            s.active = False
        picks.append(eng._pick_rows(eng.short, 8))
        ra = await asyncio.gather(*[eng.transcribe(a, SR, max_new_tokens=20) for a in small])
        rb = await asyncio.gather(*[eng.transcribe(a, SR, max_new_tokens=20) for a in big])
        return picks, [r.tokens for r in ra + rb]

    (picks_j, want), (picks, got) = _both(stack, run, slots=8, max_decode_tokens=32,
                                          n_streams=4)
    assert picks == picks_j == [1, None, 4, None, None]
    _assert_tokens(got, want, "request")
    _assert_tokens(got, golden, "request vs sequential")


def test_fused_dual_decode_matches_jax_and_sequential(stack):
    """Interim-class (short pool) and final-class (long pool) requests at
    once on an engine built with fuse_dual_decode: both pools decode in
    the dual program (dual_decodes > 0 on both engines) with the tokens of
    JAX's fused engine and of the sequential Transcriber (the JAX
    package's test_mixed_classes_fuse_and_match)."""
    _, tr = stack
    shorts = [_audio(0.3, f=220 + 50 * i, seed=30 + i) for i in range(3)]
    longs = [_audio(0.6, f=400 + 80 * i, seed=40 + i) for i in range(2)]
    golden = ([tr.transcribe(a, SR, max_new_tokens=8).tokens for a in shorts]
              + [tr.transcribe(a, SR, max_new_tokens=24).tokens for a in longs])

    async def run(eng):
        assert eng.fuse_dual
        rs = await asyncio.gather(*[eng.transcribe(a, SR, max_new_tokens=8) for a in shorts],
                                  *[eng.transcribe(a, SR, max_new_tokens=24) for a in longs])
        return [r.tokens for r in rs], eng.stats.get("dual_decodes", 0)

    (want, dual_j), (got, dual) = _both(stack, run, slots=4, max_decode_tokens=32,
                                        fuse_dual_decode=True)
    assert dual_j > 0 and dual > 0
    _assert_tokens(got, want, "request")
    _assert_tokens(got, golden, "request vs sequential")


@pytest.mark.parametrize("ration", [False, True])
def test_ration_flag_token_parity(stack, ration):
    """Both admission orders (combined, the default; short class admitted
    and decoded before the long class is admitted) give the tokens of JAX
    and of the sequential Transcriber, with short and long requests in the
    same ticks (the JAX package's test_ration_flag_token_parity)."""
    _, tr = stack
    audios = [_audio(0.3 + 0.07 * i, f=200 + 60 * i, seed=i) for i in range(6)]
    budgets = [8, 24, 8, 24, 8, 24]
    golden = [tr.transcribe(a, SR, max_new_tokens=b).tokens for a, b in zip(audios, budgets)]

    async def run(eng):
        eng.ration_long_admits = ration
        rs = await asyncio.gather(*[eng.transcribe(a, SR, max_new_tokens=b)
                                    for a, b in zip(audios, budgets)])
        return [r.tokens for r in rs]

    want, got = _both(stack, run, slots=4, max_decode_tokens=32)
    _assert_tokens(got, want, "request")
    _assert_tokens(got, golden, "request vs sequential")


def test_tick_trace_keys_match_jax(stack, monkeypatch):
    """The port's tick spans carry the keys of the JAX engine's per-tick
    records (its tick_trace, which SONIC_TICK_TRACE turns on; the port has
    neither): each phase of a JAX tick record ("<phase>_ms") is a span
    "tick.<phase>" under the span "tick" (its "total_ms"), each part of its
    admit detail a span "admit.<part>"; and the port's admit.dispatch spans
    count the prefill groups that the JAX records count."""
    monkeypatch.setenv("SONIC_TICK_TRACE", "1")

    async def run(eng):
        await asyncio.gather(eng.transcribe(_audio(0.3, seed=3), SR, max_new_tokens=8),
                             eng.transcribe(_audio(0.5, seed=4), SR, max_new_tokens=24))
        if not isinstance(eng, BatchedEngine):
            return list(eng.tick_trace)
        await eng.between_ticks(lambda: None)  # the tick that resolved them has closed
        return eng.spans.records()

    records_j, records = _both(stack, run, slots=4, max_decode_tokens=32)
    assert records_j
    phase_keys = {k[:-3] for r in records_j for k in r if k.endswith("_ms")} - {"total"}
    admit_keys = {k[:-3] for r in records_j for k in r["admit_detail"] if k.endswith("_ms")}
    groups_j = sum(r["admit_detail"]["groups_short"] + r["admit_detail"]["groups_long"]
                   for r in records_j)
    assert phase_keys == set(spans.TICK_PHASES) and admit_keys == set(spans.ADMIT_PARTS)

    under_tick = {n for n, _, _, parent, _ in records if parent == "tick"}
    assert {"tick.admit", "tick.decode_dispatch"} <= under_tick
    assert under_tick & {"tick.early_resolve", "tick.resolve"}
    assert under_tick <= {"tick." + k for k in phase_keys}
    assert {n for n, *_ in records if n.startswith("admit.")} == {"admit." + k for k in admit_keys}
    ticks = tick_phases(records)
    assert ticks and all(set(t) >= {k + "_ms" for k in phase_keys} | {"total_ms"} for t in ticks)
    groups = sum(n == "admit.dispatch" for n, *_ in records)
    assert groups == groups_j == sum(t["admit_detail"]["groups_short"]
                                     + t["admit_detail"]["groups_long"] for t in ticks) == 2


def test_base_bias_and_hotwords():
    """base_logit_bias reaches every slot's decode, a hotword boost stacks on
    it, and a slot left hotword-dirty goes back to the base bias."""
    stack = _transcribers(strength=1e12)
    tr_j, _ = stack
    cfg = tiny()
    qid, zid = tr_j.tokenizer.encode("q")[0], tr_j.tokenizer.encode("z")[0]
    base = np.zeros((cfg.decoder.vocab_size,), np.float32)
    base[qid] = 1e9
    audio = _audio(0.4, seed=9)

    async def run(eng):
        hot = await eng.transcribe(audio, SR, max_new_tokens=4, hotwords=["z"])
        plain = await eng.transcribe(audio, SR, max_new_tokens=4)
        plain2 = await eng.transcribe(audio, SR, max_new_tokens=4)
        return [r.tokens for r in (hot, plain, plain2)]

    want, got = _both(stack, run, slots=2, max_decode_tokens=16, n_streams=2,
                      base_logit_bias=base)
    _assert_tokens(got, want, "request")
    assert all(t == zid for t in got[0])  # the hotword beats the base
    assert all(t == qid for t in got[1]) and all(t == qid for t in got[2])


def test_host_vad_batch_matches_jax(stack):
    """Host-audio gate windows of four streams at once, chained over three
    windows (quiet, then speech or quiet): probabilities within VAD_TOL."""
    win = 10 * CHUNK
    quiet = [_silence(win / SR, seed=70 + i) for i in range(4)]
    loud = [_speech(win / SR, seed=80 + i) for i in range(4)]

    async def run(eng):
        states, probs = [None] * 4, []
        for w in range(3):
            audio = [quiet[i] if (w == 0 or i % 2) else loud[i] for i in range(4)]
            rs = await asyncio.gather(*[eng.vad_window_prob(a, s)
                                        for a, s in zip(audio, states)])
            probs.append([p for p, _ in rs])
            states = [s for _, s in rs]
        return np.asarray(probs)

    want, got = _both(stack, run, slots=2, n_streams=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=VAD_TOL)
    assert got[1:, 0].min() > 0.7 and got[:, 1].max() < 0.4


def test_interim_stagger_matches_jax(stack):
    async def run(eng):
        seen = [eng.interim_stagger(None)]
        claimed = []
        for _ in range(4):
            claimed.append(eng.alloc_stream())
            seen.append([eng.interim_stagger(i) for i in claimed])
        for i in claimed[:3]:
            eng.free_stream(i)
        seen.append(eng.interim_stagger(claimed[3]))  # one live stream again
        return seen

    want, got = _both(stack, run, slots=4, max_decode_tokens=32, n_streams=4)
    assert got == want
    assert got[1] == [0.0] and len(set(got[4])) > 1 and got[5] == 0.0


def test_stagger_flag_off_gives_no_phases(stack):
    """stagger_interims off: phase 0 even for a pool-filling cohort, on
    both engines (the JAX package's test_stagger_flag_off_disables_phases)."""
    async def run(eng):
        claimed = [eng.alloc_stream() for _ in range(4)]
        on = [eng.interim_stagger(i) for i in claimed]
        eng.stagger_interims = False
        return on, [eng.interim_stagger(i) for i in claimed]

    want, got = _both(stack, run, slots=4, max_decode_tokens=32, n_streams=4)
    assert got == want and got[1] == [0.0] * 4 and len(set(got[0])) > 1


def test_shutdown_fails_inflight_requests(stack):
    _, tr = stack
    audio = _audio(0.5, seed=42)

    async def go():
        eng = BatchedEngine(tr, EnergyVad(device="cpu"), slots=4, max_decode_tokens=32,
                            n_streams=4)
        await eng.transcribe(audio, SR, max_new_tokens=32)
        fut = asyncio.ensure_future(eng.transcribe(audio, SR, max_new_tokens=32))
        t0 = time.perf_counter()  # admitted and decoding, or already done
        while not (eng._n_active or fut.done()) and time.perf_counter() - t0 < 20.0:
            await asyncio.sleep(0.005)
        eng.shutdown()
        try:
            await asyncio.wait_for(fut, timeout=30.0)
            return "completed"
        except RuntimeError:
            return "failed"
        except asyncio.TimeoutError:
            return "hung"

    assert asyncio.run(go()) in ("completed", "failed")


def test_graceful_shutdown_is_not_degraded(stack):
    _, tr = stack

    async def go():
        eng = BatchedEngine(tr, EnergyVad(device="cpu"), slots=2, max_decode_tokens=16,
                            n_streams=2)
        await eng.transcribe(_audio(0.3, seed=7), SR, max_new_tokens=4)
        assert eng.alive is True
        task = eng._task
        eng.shutdown()
        t0 = time.perf_counter()  # the scheduler has stopped
        while not task.done() and time.perf_counter() - t0 < 20.0:
            await asyncio.sleep(0.005)
        assert task.done()
        return eng.alive

    assert asyncio.run(go()) is True


# ---------------------------------------------------------------------
# serving on the batched engine
# ---------------------------------------------------------------------


def test_build_runtime_and_cli_default_to_batched(monkeypatch):
    engine, _, info = build_runtime("tiny-random", "energy", AppConfig(), device="cpu")
    assert isinstance(engine, BatchedEngine) and engine.has_ring
    assert (info["engine"], info["decode_slots"]) == ("batched", 32)
    assert engine.concurrency_hint == 32 and len(engine.long.slots) == 32
    threaded, _, info_t = build_runtime("tiny-random", "energy", AppConfig(), device="cpu",
                                        engine_kind="threaded")
    threaded.shutdown()
    assert isinstance(threaded, ThreadedEngine)
    assert (info_t["engine"], info_t["decode_slots"]) == ("threaded", 1)
    with pytest.raises(ValueError, match="batched"):
        build_runtime("tiny-random", "energy", AppConfig(), device="cpu", engine_kind="fast")

    kinds = []

    class Built(Exception):
        pass

    def fake_build_runtime(*a, engine_kind, **kw):
        kinds.append(engine_kind)
        raise Built

    monkeypatch.setattr(app_module, "build_runtime", fake_build_runtime)
    for argv in (["--device", "cpu"], ["--device", "cpu", "--engine", "threaded"]):
        with pytest.raises(Built):
            app_module.main(argv)
    assert kinds == ["batched", "threaded"]


def test_server_model_defaults_to_checkpoint_path(monkeypatch, tmp_path):
    """Without --model the server serves $CHECKPOINT_PATH when that
    directory exists, else tiny-random (as the JAX server does); --model
    wins over both."""
    models = []

    class Built(Exception):
        pass

    def fake_build_runtime(model, *a, **kw):
        models.append(model)
        raise Built

    monkeypatch.setattr(app_module, "build_runtime", fake_build_runtime)
    ckpt = tmp_path / "ckpt"
    monkeypatch.setenv("CHECKPOINT_PATH", str(ckpt))
    for argv in (["--device", "cpu"], ["--device", "cpu", "--model", "nano-random"]):
        with pytest.raises(Built):
            app_module.main(argv)
    ckpt.mkdir()
    for argv in (["--device", "cpu"], ["--device", "cpu", "--model", "nano-random"]):
        with pytest.raises(Built):
            app_module.main(argv)
    assert models == ["tiny-random", "nano-random", str(ckpt), "nano-random"]


@pytest.fixture(scope="module")
def serving(stack):
    """(JAX BatchedEngine, port BatchedEngine) with 4 slots and 4 streams,
    each with its own eager-finals gate. The gate reads two wall-clock
    measures, so both engines get the same ones: every bet's outcome folds
    at once (eager_window_s 0), and the interim admission wait's EMA is
    pinned at 0 ms (under its budget: slack), each reaped interim's wait
    not folded in."""
    eng_j, eng = _engines(stack, slots=4, max_decode_tokens=256, n_streams=4)
    for e in (eng_j, eng):
        e.eager_window_s = 0.0
        e.short_queue_ema = 0.0
        e._note_short_queue = lambda q_ms: None
    yield eng_j, eng
    eng_j.shutdown()
    eng.shutdown()


async def test_transcribe_file_matches_jax_app(serving, aiohttp_client):
    eng_j, eng = serving
    cfg_j, cfg = AppConfigJax(), AppConfig()
    cfg_j.file_max_new_tokens = cfg.file_max_new_tokens = 24
    audio = np.concatenate([_silence(0.5), _speech(2.6, 2), _silence(1.5, 3), _speech(1.2, 4),
                            _silence(0.4, 5)])
    wav = write_wav(audio, SR)

    async def post(client):
        form = aiohttp.FormData()
        form.add_field("file", wav, filename="a.wav", content_type="audio/wav")
        form.add_field("config_str", json.dumps({"max_segment_duration": 2.0}))
        r = await client.post("/transcribe/file?stream=true", data=form)
        assert r.status == 200
        return [json.loads(line) for line in (await r.text()).splitlines() if line]

    want = await post(await aiohttp_client(build_app_jax(cfg_j, eng_j, eng_j.vad)))
    client = await aiohttp_client(build_app(cfg, eng, eng.vad, {"engine": "batched"}))
    got = await post(client)

    def results(msgs):
        segs = sorted((m for m in msgs if m["type"] == "segment_result"),
                      key=lambda m: m["segment_index"])
        return [{k: m[k] for k in ("segment_index", "start_time", "end_time", "text",
                                   "is_long_segment")} for m in segs]

    assert [m["type"] for m in got] == [m["type"] for m in want]
    assert got[1] == want[1]
    assert results(got) == results(want) and len(results(got)) == 3
    assert any(r["text"] for r in results(got))
    assert got[-1]["full_text"] == want[-1]["full_text"] and got[-1]["failed_segments"] == 0
    assert (await (await client.get("/debug/config")).json())["engine"] == "batched"


async def _drive(session_cls, cfg, engine, frames) -> list[dict]:
    """The frames through one session on a stepped clock (64 ms a frame),
    each window's work done before the next frame, then the close path.
    -> the messages without processing_delay."""
    msgs, now = [], [0.0]

    async def send(m):
        msgs.append(m)

    tracked = Tracked(engine)
    session = session_cls("c1", cfg, tracked, send, clock=lambda: now[0])
    assert session.stream_idx is not None  # the ring path
    for i, frame in enumerate(frames):
        now[0] = i * cfg.audio_chunk_duration_ms / 1000.0
        await session.on_audio(frame)
        await settle(session, tracked)
    await session.flush()
    await session.cleanup()
    return [{k: v for k, v in m.items() if k != "processing_delay"} for m in msgs]


async def test_stream_session_messages_match_jax(serving):
    """Two utterances through a StreamSession on each batched engine (the
    ring path: ingest, ring VAD, ring interims, eager finals through the
    gate, drafted finals on the verify program): every message equal on a
    stepped clock."""
    eng_j, eng = serving
    pcm = _pcm(np.concatenate([_silence(0.7, 11), _speech(2.3, 12), _silence(2.0, 13),
                               _speech(1.4, 14), _silence(2.0, 15)]))
    frames = [pcm[i : i + 2 * CHUNK].ljust(2 * CHUNK, b"\0") for i in range(0, len(pcm), 2 * CHUNK)]
    rounds0, granted0 = eng.stats["verify_rounds"], eng.stats["eager_granted"]
    want = await _drive(StreamSessionJax, AppConfigJax(), eng_j, frames)
    got = await _drive(StreamSession, AppConfig(), eng, frames)
    assert got == want
    # both finals launched eagerly through the gate, and their drafts (the
    # banked interims) went through the verify program
    assert eng.stats["eager_granted"] - granted0 == 2
    assert eng.stats["verify_rounds"] > rounds0
    kinds = [m["type"] for m in got]
    assert kinds.count("committed_output") == 2 and "tentative_output" in kinds
    assert any(m["text"] for m in got if m["type"] == "committed_output")


async def test_ws_committed_texts_match_jax_app(serving, aiohttp_client):
    """The same frames over /ws/audio to the port's app and the JAX app,
    both on their batched engines: the same committed segments and texts."""
    eng_j, eng = serving
    pcm = _pcm(np.concatenate([_silence(0.7, 31), _speech(2.0, 32), _silence(2.0, 33),
                               _speech(1.2, 34), _silence(2.0, 35)]))

    async def stream(client) -> list[dict]:
        ws = await client.ws_connect("/ws/audio")
        await ws.receive_str()
        msgs = []

        async def reader():
            async for m in ws:
                msgs.append(json.loads(m.data))

        task = asyncio.ensure_future(reader())
        for off in range(0, len(pcm), 2048):
            await ws.send_bytes(pcm[off : off + 2048])
            await asyncio.sleep(0.001)
        for _ in range(1200):
            if sum(m["type"] == "committed_output" for m in msgs) >= 2:
                break
            await asyncio.sleep(0.05)
        await ws.send_str(json.dumps({"type": "close"}))
        await ws.close()
        await task
        keys = ("segment_id", "text", "start_chunk_id", "end_chunk_id", "start_time",
                "end_time")
        return [{k: m[k] for k in keys} for m in msgs if m["type"] == "committed_output"]

    want = await stream(await aiohttp_client(build_app_jax(AppConfigJax(), eng_j, eng_j.vad)))
    got = await stream(await aiohttp_client(build_app(AppConfig(), eng, eng.vad)))
    assert got == want and [m["segment_id"] for m in got] == ["0", "1"]
    assert any(m["text"] for m in got)
