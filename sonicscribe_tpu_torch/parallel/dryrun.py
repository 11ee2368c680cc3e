"""Multi-card dry run of data- and tensor-parallel serving.

The port's twin of the JAX package's ``__graft_entry__.py:dryrun_multichip``.
The data-parallel leg: the real serving engine over an n-row mesh
(``engine/replicas.py``: a batcher per row, the weights copied to each
row's device) drives the whole pipeline through its own schedulers:
packed chunk ingest -> batched ring VAD -> batched ring prefill -> K-step
batched greedy decode -> reap, on 2n streams spread over the replicas,
plus the host-audio path. The dp x tp leg, where n is even: the same
engine over an (n/2) x 2 mesh, each data row a tensor-parallel pair whose
ranks hold the head-aligned Megatron shards (parallel/mesh.py:
shard_params_tp) and meet in an all-reduce (parallel/tp.py), serves one
host request natively and once more in int8-decoder-a8 (W8A8 decode, each
row's max|x| max-reduced over the ranks before a row-parallel product). A
pair needs two cards (NCCL refuses two ranks on one), so on cards the leg
runs only where each row's two devices differ; on the CPU both ranks are
gloo ranks on threads.

Run on the cards (one row per card, at least n of them):
    python -m sonicscribe_tpu_torch.parallel.dryrun 2
or on the CPU, every row on it:
    python -m sonicscribe_tpu_torch.parallel.dryrun 4 --cpu
"""

from __future__ import annotations

import argparse
import asyncio
from dataclasses import replace
from typing import Optional, Sequence

import numpy as np
import torch

N_CHUNKS = 20  # one 128-frame mel bucket
MAX_NEW = 8


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """Serve 2 * n_devices streams and one host request over an
    n_devices-row mesh of `devices` (default: the first n_devices cards;
    raises with fewer), tiny() f32 random weights from seed 0; then the
    dp x tp leg (``tp_leg``, native and int8-decoder-a8) where n_devices is
    even and each pair of devices is two cards or the CPU. Asserts what the
    JAX dry run asserts, with each replica's slots and ring on its own
    device. -> {"tokens", "host_tokens", "probs", "devices", "tp_tokens",
    "tp_a8_tokens" (both None where the leg did not run)}."""
    from sonicscribe_tpu_torch.engine.replicas import DataParallelEngine
    from sonicscribe_tpu_torch.engine.transcriber import Transcriber
    from sonicscribe_tpu_torch.models.config import tiny
    from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
    from sonicscribe_tpu_torch.models.weights import init_random
    from sonicscribe_tpu_torch.parallel.mesh import make_mesh
    from sonicscribe_tpu_torch.vad.model import EnergyVad

    if devices is None:
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"{n_devices} cards needed, {torch.cuda.device_count()} present; "
                               "pass devices= (a card may be named more than once)")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    mesh = make_mesh(n_devices, devices=devices)
    dev0 = mesh.data_devices[0]
    cfg = tiny()
    params = init_random(cfg, 0, dtype=torch.float32, device=dev0)
    tr = Transcriber(cfg, params, ByteTokenizer(cfg), prefill_buckets=(128,))

    S = 2 * n_devices  # concurrent streams, spread over the replicas
    engine = DataParallelEngine(tr, EnergyVad(device=dev0), mesh, slots=S, max_decode_tokens=32,
                                n_streams=S)
    assert engine.data_parallel == n_devices
    for rep, dev in zip(engine.replicas, mesh.data_devices):
        assert rep.device == dev and rep.ring.device == dev, (rep.device, rep.ring.device, dev)
        assert all(t.device == dev for p in rep.pools for t in p.state.values())

    rng = np.random.default_rng(0)
    pcm = [(rng.standard_normal((N_CHUNKS * 1024,)) * 3000).astype("<i2").tobytes()
           for _ in range(S)]

    async def serve_all():
        streams = [engine.alloc_stream() for _ in range(S)]
        assert all(s is not None for s in streams)
        owners = {s // engine.rows_per_replica for s in streams}
        assert owners == set(range(n_devices)), f"streams {streams} not on every replica"
        # 1) packed chunk ingest into each replica's device ring
        for c in range(N_CHUNKS):
            for i, s in enumerate(streams):
                engine.ingest(s, c, pcm[i][c * 2048:(c + 1) * 2048])
        # 2) batched ring VAD with device-resident state
        probs = await asyncio.gather(*[engine.vad_window_ring(s, 0) for s in streams])
        # 3+4) batched ring prefill + batched decode, every stream at once
        results = await asyncio.gather(*[
            engine.transcribe_ring(s, 0, N_CHUNKS, max_new_tokens=MAX_NEW,
                                   hotwords=["mesh"] if i % 2 else None)
            for i, s in enumerate(streams)])
        # the host-audio path over the replicas too
        host = await engine.transcribe(
            np.frombuffer(pcm[0], "<i2").astype(np.float32) / 32768.0, 16000,
            max_new_tokens=MAX_NEW)
        for s in streams:
            engine.free_stream(s)
        return probs, results, host

    try:
        probs, results, host = asyncio.run(serve_all())
    finally:
        engine.shutdown()

    assert len(results) == S
    assert all(0.0 <= p <= 1.0 for p in probs)
    assert all(1 <= len(r.tokens) <= MAX_NEW for r in results)
    assert 1 <= len(host.tokens) <= MAX_NEW
    for i, rep in enumerate(engine.replicas):
        assert rep.stats["decode_steps"] > 0, f"replica {i} decoded nothing"
    flat = mesh.data_devices
    pairs = [flat[i:i + 2] for i in range(0, n_devices, 2)]
    tp_ok = n_devices % 2 == 0 and all(a.type == "cpu" or a != b for a, b in pairs)
    tp_tokens = tp_leg(n_devices, flat, pcm[0]) if tp_ok else None
    tp_a8_tokens = tp_leg(n_devices, flat, pcm[0], a8=True) if tp_ok else None
    print(f"dryrun_multichip OK: {n_devices} devices, {S} streams, mesh={mesh.shape}, "
          f"data-parallel BatchedEngine executed the full pipeline (packed ingest -> ring VAD "
          f"-> ring prefill -> {MAX_NEW}-step decode -> reap) + host-audio path"
          + (f"; dp x tp mesh {{'data': {n_devices // 2}, 'model': 2}} decoded {len(tp_tokens)} "
             f"tokens, {len(tp_a8_tokens)} in int8-decoder-a8" if tp_ok
             else "; no dp x tp leg (it needs pairs of distinct cards)"))
    return {"tokens": [list(map(int, r.tokens)) for r in results],
            "host_tokens": list(map(int, host.tokens)), "probs": [float(p) for p in probs],
            "devices": [str(d) for d in mesh.data_devices], "tp_tokens": tp_tokens,
            "tp_a8_tokens": tp_a8_tokens}


def tp_leg(n_devices: int, devices: Sequence, pcm: bytes, a8: bool = False) -> list[int]:
    """The dp x tp leg (the JAX dry run's, __graft_entry__.py:164-192): an
    (n/2) x 2 mesh of `devices`, tiny() f32 from seed 0, serves one host
    request of `pcm`; with `a8`, in int8-decoder-a8 (the decoder's
    projections int8, quantised whole and then cut; W8A8 decode). Asserts
    data_parallel == n / 2, that each rank's qkv_w holds its head-aligned
    sections ([L, d, (nh + 2 nkv) hd / 2]: its q heads, then its k and its
    v heads) on its device, and at least one decoded token (with `a8`, at
    least one decode step, the W8A8 products). -> the tokens."""
    from sonicscribe_tpu_torch.engine.replicas import DataParallelEngine
    from sonicscribe_tpu_torch.engine.transcriber import Transcriber
    from sonicscribe_tpu_torch.models.config import tiny
    from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
    from sonicscribe_tpu_torch.models.weights import init_random
    from sonicscribe_tpu_torch.ops.quant import dequantize_tensor, quantize_params_int8
    from sonicscribe_tpu_torch.parallel.mesh import make_mesh
    from sonicscribe_tpu_torch.vad.model import EnergyVad

    mesh = make_mesh(n_devices, model_parallel=2, devices=devices)
    cfg = tiny()
    dev0 = mesh.devices[0][0]
    params = init_random(cfg, 0, dtype=torch.float32, device=dev0)
    if a8:
        params = quantize_params_int8(params, decoder_only=True)
        cfg = replace(cfg, decoder=replace(cfg.decoder, act_int8_decode=True))
    tr = Transcriber(cfg, params, ByteTokenizer(cfg), prefill_buckets=(128,))
    engine = DataParallelEngine(tr, EnergyVad(device=dev0), mesh, slots=max(2, n_devices // 2),
                                max_decode_tokens=32, n_streams=2)
    assert engine.data_parallel == n_devices // 2, engine.data_parallel
    dec = cfg.decoder
    nq, nkv = dec.n_heads * dec.head_dim // 2, dec.n_kv_heads * dec.head_dim // 2
    def dense(w):
        return dequantize_tensor(w) if a8 else w

    full = dense(params["decoder"]["layers"]["qkv_w"])
    for row, rep in zip(mesh.devices, engine.replicas):
        for r, (dev, eng) in enumerate(zip(row, rep._ranks)):
            qkv = dense(eng.transcriber.params["decoder"]["layers"]["qkv_w"])
            assert tuple(qkv.shape) == (dec.n_layers, dec.d_model, nq + 2 * nkv), qkv.shape
            assert qkv.device == dev, (qkv.device, dev)
            for at, start in ((0, r * nq), (nq, 2 * nq + r * nkv),
                              (nq + nkv, 2 * nq + 2 * nkv + r * nkv)):
                n = nq if at == 0 else nkv
                assert torch.equal(qkv[..., at:at + n].cpu(), full[..., start:start + n].cpu())
    try:
        result = asyncio.run(engine.transcribe(
            np.frombuffer(pcm, "<i2").astype(np.float32) / 32768.0, 16000,
            max_new_tokens=MAX_NEW))
        decode_steps = sum(s["decode_steps"] for s in engine.stats["replicas"])
    finally:
        engine.shutdown()
    assert 1 <= len(result.tokens) <= MAX_NEW, result.tokens
    assert not a8 or decode_steps > 0, "the int8-decoder-a8 request took no decode step"
    return list(map(int, result.tokens))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="data-parallel serving dry run")
    ap.add_argument("n_devices", type=int, nargs="?", default=2)
    ap.add_argument("--cpu", action="store_true", help="every row on the CPU")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, ["cpu"] * args.n_devices if args.cpu else None)


if __name__ == "__main__":
    main()
