"""Kernel probes of the traced run: each kernel timed alone on the card.

After the window, the metric reader of a kernel's roofline calls its probe
with the shapes under ``probes`` in ``workloads/<cell>.json``; the probe
launches the port's kernel through its entry, at the rows and lengths the
file gives (lengths drawn from the seed), over stacks of layers so that
each launch finds its inputs cold in L2, as a decode step does. Time comes
from CUDA events around all the launches; bytes from ``roofline.py``;
the share is the bytes bound at the data sheet's rate over that time.

- ``decode_attention``: ``ops/decode_attention.py:decode_attention`` on
  rows x [cache_len] bf16 caches, one per layer.
"""

from __future__ import annotations

import numpy as np

from gpubench import roofline


def _time_ms(torch, device, launch, n: int) -> float:
    launch(0)
    torch.cuda.synchronize(device)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(n):
        launch(i)
    b.record()
    torch.cuda.synchronize(device)
    return a.elapsed_time(b)


def decode_attention(cfg: dict, spec: dict, seed: int, device) -> dict:
    import torch

    from sonicscribe_tpu_torch.ops.decode_attention import decode_attention as attend

    dec = cfg["model"]["decoder"]
    rows, M, L = spec["rows"], spec["cache_len"], spec["layers"]
    nh, nkv, hd = dec["n_heads"], dec["n_kv_heads"], dec["head_dim"]
    rng = np.random.default_rng([seed, 11])
    lens = rng.integers(spec["len_lo"], spec["len_hi"] + 1, size=rows)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    k = torch.randn((L, rows, M, nkv, hd), generator=gen, device=device, dtype=torch.bfloat16)
    v = torch.randn((L, rows, M, nkv, hd), generator=gen, device=device, dtype=torch.bfloat16)
    q = torch.randn((rows, nh, hd), generator=gen, device=device, dtype=torch.bfloat16)
    lens_t = torch.as_tensor(lens, dtype=torch.int32, device=device)
    n = L * spec["reps"]
    ms = _time_ms(torch, device, lambda i: attend(q, k[i % L], v[i % L], lens_t), n) / n
    out_elem = attend(q, k[0], v[0], lens_t).element_size()
    nbytes = roofline.decode_attention_bytes(rows, lens, nh, nkv, hd, 2, out_elem)
    del k, v
    torch.cuda.empty_cache()
    return {"ms": ms, "bytes": nbytes,
            "roofline_pct": 100.0 * nbytes / roofline.PEAK_HBM_BYTES / (ms / 1e3)}

