"""The port's bigger serving benches (spec, mixed, scale), one leg or one
micro size each on the CPU (tiny f32, accelerated), against the keys of the
JAX package's artifacts at the repo root; see test_torch_bench_tools.py
for the rule. Keys of a leg are compared by the leg's name: the mixed
bench's `<tag>_*` fields, the scale bench's `knee_<N>` rows and
`stream100<tag>_*` fields."""

import json

from sonicscribe_tpu_torch.tools import bench_mixed, bench_scale, bench_spec, loadtest
from test_torch_bench_tools import DEVICE_KEYS, TPU_PROBES, check_keys, jax_artifact, run


def test_bench_spec():
    """A spec-on session leg, the golden-draft ceiling and one agreement
    leg; in float32 every drafted final gives the plain tokens (measure
    raises otherwise)."""
    out = run(bench_spec, lambda e: bench_spec.measure(
        e, True, 3, 3.0, realtime=False, specs=(True,), workloads=bench_spec.WORKLOADS[:1],
        fractions=(0.5,)))
    want = check_keys(out, "SPEC_FINALS_BENCH.json", {"note_token_mismatches"})
    by_name = {v["variant"]: v for v in want["variants"]}
    legs = {v["variant"]: v for v in out["variants"]}
    assert set(legs) == {"worst_case_spec", "ceiling_golden_drafts", "agreement_50"}
    for name, leg in legs.items():
        assert set(by_name[name]) <= set(leg), name
        assert leg.get("token_mismatches", 0) == 0
    assert legs["ceiling_golden_drafts"]["verify_rounds"] > 0
    assert legs["worst_case_spec"]["errors"] == 0


# the JAX artifact's keys with no counterpart: the runtime's probes, the
# prose of its rounds, the probes of its int8dec run, the fuse_slot_writes
# control leg (the port's prefill graphs write the slots' state: no choice)
MIXED_TPU_ONLY = TPU_PROBES | {
    "note_r4_ab", "note_r5_close", "note_r5_adaptive_k_regression_check", "note_r5_int8dec",
    "note_r5_restore", "tunnel_rtt_ms_int8dec_run", "compile_probe_s_int8dec_run"}
MIXED_NO_LEG = {"nofuse"}


def test_bench_mixed():
    """The shipped leg beside the 3-segment file job (which starts with the
    streams): the JAX artifact's fields of every leg the port runs, by its
    tag; the int8dec leg (--int8dec) has the same fields."""
    out = bench_mixed.bench(True, "cpu", 3, 3.0, realtime=False,
                            variants=bench_mixed.VARIANTS[:1], file_delay_s=0.0)
    json.dumps(out)
    want = jax_artifact("MIXED_BENCH.json")
    tags = [v[0] for v in bench_mixed.VARIANTS] + ["int8dec"]
    legs = {k for k in want if any(k.startswith(f"{t}_") for t in tags + list(MIXED_NO_LEG))}
    assert MIXED_TPU_ONLY <= set(want)
    assert set(want) - legs - MIXED_TPU_ONLY <= set(out)
    fields = {k[len("shipped_"):] for k in out if k.startswith("shipped_")}
    for tag in tags:
        jax_fields = {k[len(tag) + 1:] for k in want if k.startswith(f"{tag}_")}
        assert jax_fields and jax_fields <= fields, tag
    assert out["shipped_errors"] == 0 and out["shipped_captured_on_run"] == 0
    assert out["shipped_committed"] >= 3 and out["shipped_file_rtf"] > 0
    assert set(out["shipped_tick_decomposition"]) <= {"in_file", "out_file"}
    assert DEVICE_KEYS <= set(out) and out["backend"] == "cpu"


MICRO = dict(file_segments=2, file_bucket=128, file_budget=8, knee=(2,), knee_settle_s=1.0,
             window_s=2.0, streams=2, stream_settle_s=1.0, slots=2, ring=4, remedy_slots=4)
# the runtime's probes and its prose; file_long_vs_baseline (the ratio to a
# TPU-era target); rows of earlier JAX rounds that its current code no
# longer writes (remedy_k16_100, knee_<N>_control_k8)
SCALE_TPU_ONLY = TPU_PROBES | {
    "note", "note_r5_adaptive_k", "note_knee_keys", "note_r4_stream100",
    "file_long_vs_baseline", "remedy_k16_100", "knee_60_control_k8", "knee_75_control_k8",
    "knee_90_control_k8", "knee_100_control_k8"}


def test_bench_scale():
    """Every section at a micro size, with the opt-in legs: the file leg,
    the knee at 2 streams, its k-cap control and the bigger pool, and the
    four stream legs (the stagger A/B). Knee rows are named by their stream count, so the JAX rows'
    fields are held to the port's row."""
    tags = bench_scale.stream_tags(stagger_ab=True)
    out = bench_scale.bench(True, "cpu", MICRO, realtime=False, remedy_slots=True, tags=tags)
    json.dumps(out)
    want = jax_artifact("SCALE_BENCH.json")
    assert SCALE_TPU_ONLY <= set(want)
    knee_rows = {k for k in want if k.startswith("knee_") and k[5:].isdigit()}
    missing = set(want) - SCALE_TPU_ONLY - knee_rows - set(out)
    assert not missing, sorted(missing)
    for k in knee_rows:
        assert set(want[k]) <= set(out["knee_2"]), k
    assert set(want["control_k8_100"]) <= set(out["control_k8_100"])
    assert set(out["remedy_slots96_100"]) == set(out["control_k8_100"]) | {"slots"}
    assert out["file_long_rtf"] > 0 and out["knee_2"]["errors"] == 0
    for tag, _, _ in tags:
        assert out[f"stream100{tag}_errors"] == 0 and out[f"stream100{tag}_committed"] >= 2
        assert out[f"stream100{tag}_host_path_sessions"] == 0
    assert DEVICE_KEYS <= set(out) and out["backend"] == "cpu"


def test_host_path_sessions_past_the_ring():
    """A ring of 2 rows at 4 streams: two sessions take the host path."""
    engine = loadtest.bench_engine(True, "cpu", n_streams=2)
    assert loadtest.host_path_sessions(engine, 4) == 2
    assert loadtest.host_path_sessions(engine, 1) == 0
