"""The decode microbenches (tools/bench_hbm, bench_decode_parts,
bench_decode, bench_rows, bench_flash) on the CPU, tiny f32, against the
JAX package.

- The parts of bench_decode_parts against the same compositions built here
  from the JAX package's `_rms_norm`, `ops.quant.matmul`, `_lm_logits` and
  an einsum attention (the JAX bench's closures), the weights carried by
  params_from_jax: within 2e-4 (float32, sums in another order). `full`'s
  tokens equal a JAX decode_step loop's.
- bench_rows' programs give JAX's `_decode_k_program(rows=)` tokens and
  status on the same state, and leave the rows past the prefix untouched.
- bench_flash's SDPA function is decode_attention_plain within 1e-5 at
  lens 0, mid and max_len - 1; the route it binds is undone after it.
- bench_hbm's read step is numpy's sum.
- Each twin's `--quick --device cpu` JSON holds the keys of the JAX
  artifact at the repo root, less the ones listed by name below with why
  they have no counterpart on the card.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicscribe_tpu.engine.batcher import _decode_k_program as jax_decode_k_program
from sonicscribe_tpu.models import glm_asr as jm
from sonicscribe_tpu.models import tiny as tiny_jax
from sonicscribe_tpu.ops.quant import matmul as jax_matmul
from sonicscribe_tpu_torch.models import glm_asr as tm
from sonicscribe_tpu_torch.models import tiny
from sonicscribe_tpu_torch.models.weights import params_from_jax
from sonicscribe_tpu_torch.ops import decode_attention as attention_ops
from sonicscribe_tpu_torch.tools import (
    bench_decode,
    bench_decode_parts,
    bench_flash,
    bench_hbm,
    bench_rows,
)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)
SLOTS, MAX_LEN, K = 3, 40, 3


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg_t = tiny_jax(), tiny()
    # scaled so greedy tokens vary (at init scale it repeats one token)
    params_j = jax.tree.map(
        lambda x: x * 4.0, jm.init_params(cfg_j, jax.random.PRNGKey(11), dtype=jnp.float32))
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def jax_layers(params_j, cfg_j):
    layers = params_j["decoder"]["layers"]
    return [jax.tree.map(lambda x: x[i], layers) for i in range(cfg_j.decoder.n_layers)]


def test_mlp_chain_equals_the_jax_composition(setup):
    cfg_j, cfg_t, params_j, params_t = setup
    dec = cfg_j.decoder
    h0 = np.random.default_rng(1).standard_normal((SLOTS, dec.d_model)).astype(np.float32)
    h = jnp.asarray(h0)
    for _ in range(K):
        for lp in jax_layers(params_j, cfg_j):
            hn = jm._rms_norm(h, lp["ln1_scale"], dec.rms_eps)
            qkv = jax_matmul(hn, lp["qkv_w"])
            h = h + jax_matmul(qkv[..., : dec.n_heads * dec.head_dim], lp["o_w"])
            hn = jm._rms_norm(h, lp["ln2_scale"], dec.rms_eps)
            gate, up = jnp.split(jax_matmul(hn, lp["gate_up_w"]), 2, axis=-1)
            h = h + jax_matmul(jax.nn.silu(gate) * up, lp["down_w"])
    got = bench_decode_parts.mlp_chain(params_t, cfg_t, torch.from_numpy(h0), K)
    np.testing.assert_allclose(got.numpy(), np.asarray(h), **TOL)


def test_attn_chain_equals_an_einsum_attention(setup):
    cfg_j, cfg_t, _, _ = setup
    dec = cfg_j.decoder
    rng = np.random.default_rng(2)
    shape = (dec.n_layers, SLOTS, MAX_LEN, dec.n_kv_heads, dec.head_dim)
    kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    # lens 0, mid and max_len - 1: one position, some, all
    lens = np.array([0, MAX_LEN // 2, MAX_LEN - 1], np.int32)
    q0 = rng.standard_normal((SLOTS, dec.n_heads * dec.head_dim)).astype(np.float32)
    nkv, g, hd = dec.n_kv_heads, dec.n_heads // dec.n_kv_heads, dec.head_dim
    valid = np.arange(MAX_LEN)[None, :] <= lens[:, None]
    q = jnp.asarray(q0)
    for _ in range(K):
        for i in range(dec.n_layers):
            qg = q.reshape(SLOTS, nkv, g, hd)
            scores = jnp.einsum("bkgd,bskd->bkgs", qg, kc[i]) / np.sqrt(hd)
            scores = jnp.where(valid[:, None, None, :], scores, jm.NEG_INF)
            attn = jax.nn.softmax(scores, axis=-1)
            q = jnp.einsum("bkgs,bskd->bkgd", attn, vc[i]).reshape(SLOTS, dec.n_heads * hd)
    got = bench_decode_parts.attn_chain(cfg_t, torch.from_numpy(kc), torch.from_numpy(vc),
                                        torch.from_numpy(lens), torch.from_numpy(q0), K)
    np.testing.assert_allclose(got.numpy(), np.asarray(q), **TOL)


def test_lm_head_equals_the_jax_composition(setup):
    cfg_j, cfg_t, params_j, params_t = setup
    h0 = np.random.default_rng(3).standard_normal(
        (SLOTS, cfg_j.decoder.d_model)).astype(np.float32)
    h = jnp.asarray(h0)
    for _ in range(K):
        tok = jnp.argmax(jm._lm_logits(params_j, cfg_j, h), -1)
        h = h + params_j["decoder"]["embed"][tok]
    got = bench_decode_parts.lm_head(params_t, cfg_t, torch.from_numpy(h0), K)
    np.testing.assert_allclose(got.numpy(), np.asarray(h), **TOL)


def test_full_tokens_equal_a_jax_decode_step_loop(setup):
    cfg_j, cfg_t, params_j, params_t = setup
    dec = cfg_j.decoder
    rng = np.random.default_rng(4)
    shape = (dec.n_layers, SLOTS, MAX_LEN, dec.n_kv_heads, dec.head_dim)
    kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    lens = rng.integers(MAX_LEN // 2, MAX_LEN - K - 1, SLOTS).astype(np.int32)
    toks0 = rng.integers(0, dec.vocab_size, SLOTS).astype(np.int32)
    cache_j = {"k": jnp.asarray(kc), "v": jnp.asarray(vc), "len": jnp.asarray(lens)}
    toks, want = jnp.asarray(toks0), []
    for _ in range(K):
        cache_j, logits = jm.decode_step(params_j, cfg_j, cache_j, toks)
        toks = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(toks))
    cache_t = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy()),
               "len": torch.from_numpy(lens.copy())}
    tokens = torch.from_numpy(toks0.copy())
    got = [bench_decode_parts.full(params_t, cfg_t, cache_t, tokens, 1).clone().numpy()
           for _ in range(K)]
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert len(set(np.stack(want).ravel().tolist())) > 1  # the tokens vary
    np.testing.assert_array_equal(cache_t["len"].numpy(), np.asarray(cache_j["len"]))
    np.testing.assert_allclose(cache_t["k"].numpy(), np.asarray(cache_j["k"]), **TOL)
    # the k-step chain is k single steps
    cache_k = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy()),
               "len": torch.from_numpy(lens.copy())}
    out = bench_decode_parts.full(params_t, cfg_t, cache_k, torch.from_numpy(toks0.copy()), K)
    np.testing.assert_array_equal(out.numpy(), want[-1])


@pytest.mark.parametrize("rows", [2, 4, None])
def test_rows_program_equals_jax_and_leaves_the_rows_past_its_prefix(setup, rows):
    cfg_j, cfg_t, params_j, params_t = setup
    S, max_len, max_new, k, low = 5, 160, 16, 4, 2
    bufs = bench_rows.fresh_state(cfg_t, S, max_len, max_new, torch.float32, "cpu", seed=0)
    bufs["done"][low:] = True
    state = {n: t.numpy().copy() for n, t in bufs.items()}
    R = S if rows is None else rows
    before = {n: bench_rows.past(n, bufs, R).clone() for n in bench_rows.STATE}
    bench_rows.rows_program(params_t, cfg_t, k, rows)(bufs)
    r = jax_decode_k_program(
        params_j, cfg_j, *(jnp.asarray(state[n]) for n in
                           ("k", "v", "len", "tok", "out", "n", "done", "bias", "budget")),
        k, rows=rows)
    names = ("k", "v", "len", "tok", "out", "n", "done", "status")
    for name, want in zip(names, r):
        got = bufs[name].numpy()
        if name in ("k", "v"):
            np.testing.assert_allclose(got, np.asarray(want), **TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    for name in bench_rows.STATE:
        assert torch.equal(bench_rows.past(name, bufs, R), before[name]), name
    assert (bufs["n"][:low] == 1 + k).all()  # the active slots ran every step


def test_rows_parity_check(setup):
    _, cfg_t, _, params_t = setup
    got = bench_rows.parity(params_t, cfg_t, torch.device("cpu"), 5, 160, 16, 4, (2, 4, None))
    assert got == {"2": "ok", "4": "ok", "full": "ok"}


@pytest.mark.parametrize("lens", [0, 20, 39])
def test_sdpa_route_equals_the_plain_attention(lens):
    rng = np.random.default_rng(5)
    S, M, nh, nkv, hd = 3, 40, 4, 2, 32
    q = torch.from_numpy(rng.standard_normal((S, nh, hd)).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal((S, M, nkv, hd)).astype(np.float32))
              for _ in range(2))
    ln = torch.tensor([lens, lens // 2, lens], dtype=torch.int32)
    got = bench_flash.sdpa_decode_attention(q, kc, vc, ln)
    want = attention_ops.decode_attention_plain(q, kc, vc, ln)
    assert got.dtype == torch.float32 and got.shape == (S, nh * hd)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_sdpa_route_is_undone_after_the_block():
    kernel = attention_ops.decode_attention
    assert tm.decode_attention is kernel
    with bench_flash.sdpa_route():
        assert tm.decode_attention is bench_flash.sdpa_decode_attention
    assert tm.decode_attention is kernel
    with pytest.raises(RuntimeError), bench_flash.sdpa_route():
        raise RuntimeError("a failed capture")
    assert tm.decode_attention is kernel


@pytest.mark.parametrize("name", list(bench_hbm.ARRAYS))
def test_hbm_read_step_is_the_numpy_sum(name):
    gen = torch.Generator()
    gen.manual_seed(0)
    x = bench_hbm.make_array(name, 64 * bench_hbm.ROWS_2D, gen, "cpu")
    got = float(bench_hbm.read_step(torch.zeros(()), x))
    if x.dtype == torch.int8:
        assert got == float(x.numpy().astype(np.int64).sum())
    else:
        vals = x.float().numpy().astype(np.float64)
        assert abs(got - vals.sum()) <= 1e-5 * np.abs(vals).sum()
    assert x.numel() * x.element_size() == 64 * bench_hbm.ROWS_2D
    assert x.dim() == (2 if bench_hbm.ARRAYS[name][1] else 1)


def test_rooflines_at_the_data_sheet_and_a_measured_rate():
    r = bench_hbm.rooflines("w", 3.35e9, 1675.0)
    assert r == pytest.approx({"roofline_w_ms": 1.0, "roofline_w_ms_measured": 2.0})
    assert bench_hbm.rooflines("w", 1e9, None)["roofline_w_ms_measured"] is None
    assert bench_hbm.measured_rate("cpu") is None


# the JAX artifacts' keys that have no counterpart in the port's JSON, by
# name, with why
TPU_ONLY = {
    # prose about the v5e run (its roofline at 819 GB/s, its run-to-run drift)
    "DECODE_PARTS_BENCH.json": {"analysis"},
    # the layer-scan K/V write placements: the port's step has no layer scan
    # (it writes each layer's K/V in place), so its legs are graph and eager
    "DECODE_STEP_BENCH.json": {f"{pool}_{leg}_{m}" for pool in ("pool50x896", "pool8x2560")
                               for leg in ("readonly", "inscan", "inscan_unroll4")
                               for m in ("ms_per_step", "tok_per_s")},
    # JAX pads the long pool to a multiple of 128 positions (896): its
    # max_len - 8 is 888. The port's pool holds 803, so these are occ795_*
    "FLASH_DECODE_BENCH.json": {k for k in json.loads(
        (ROOT / "FLASH_DECODE_BENCH.json").read_text()) if k.startswith("occ888_")},
}
TWINS = {"HBM_BENCH.json": bench_hbm, "DECODE_PARTS_BENCH.json": bench_decode_parts,
         "DECODE_STEP_BENCH.json": bench_decode, "ROWS_DECODE_BENCH.json": bench_rows,
         "FLASH_DECODE_BENCH.json": bench_flash}


@pytest.mark.parametrize("artifact", list(TWINS))
def test_quick_cpu_json_holds_the_jax_artifact_keys(artifact, tmp_path, capsys):
    out_file = tmp_path / "out.json"
    TWINS[artifact].main(["--quick", "--device", "cpu", "--out", str(out_file)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    got = json.loads(line)
    assert got == json.loads(out_file.read_text())
    want = json.loads((ROOT / artifact).read_text())
    tpu_only = TPU_ONLY.get(artifact, set())
    assert tpu_only <= set(want)
    missing = set(want) - tpu_only - set(got)
    assert not missing, f"{artifact} keys missing: {sorted(missing)}"
    assert got["backend"] == "cpu" and got["card"] is None
    if artifact == "HBM_BENCH.json":
        for name in bench_hbm.ARRAYS:
            assert set(want[name]) <= set(got[name]) and got[name]["eff_gb_s"] > 0
    elif artifact == "DECODE_PARTS_BENCH.json":
        assert got["split_by_op"] is None  # a device metric: the card's only
        assert all(got[f"{p}_ms_per_step"] > 0 for p in ("mlp_chain", "attn_chain", "lm_head",
                                                          "full"))
    elif artifact == "DECODE_STEP_BENCH.json":
        for pool, _, _ in bench_decode.POOLS:
            for leg in bench_decode.LEGS:
                assert got[f"{pool}_{leg}_ms_per_step"] > 0
                assert got[f"{pool}_{leg}_tok_per_s"] > 0
    elif artifact == "ROWS_DECODE_BENCH.json":
        entry = set(next(iter(want["results"].values())))
        assert set(got["results"]) == {"2", "4", "full"}
        for r in got["results"].values():
            assert entry <= set(r) and r["parity"] == "ok" and r["token_match_vs_full"] == 1.0
    else:
        occ = got["max_len"] - 8
        for key in tpu_only:
            assert key.replace("occ888_", f"occ{occ}_") in got
        for o in (64, 256, occ):
            assert got[f"occ{o}_agreement"] <= bench_flash.AGREE_TOL
