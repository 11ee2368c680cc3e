"""A cell of the benchmark at the port's tiny() size, for the CPU tests."""

from __future__ import annotations

import copy

from gpubench import manifest

TINY_MODEL = {
    "encoder": {"n_mels": 128, "d_model": 64, "n_heads": 4, "n_layers": 2, "ffn_mult": 4,
                "max_frames": 512},
    "decoder": {"vocab_size": 384, "d_model": 128, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
                "head_dim": 32, "ffn_hidden": 256, "rope_theta": 10000.0,
                "partial_rotary_factor": 0.5, "rms_eps": 1e-05},
    "adapter_stack": 4, "adapter_hidden": 128,
}


def tiny_config(base: str = "nano-bf16", root=manifest.ROOT) -> dict:
    """A configuration file's dict at tiny() in float32 (the port's
    'tiny-random' spec serves mel buckets 128 and 256 only)."""
    cfg = manifest._load_json(root / "gpubench" / "configs" / f"{base}.json")
    cfg.update(spec="tiny-random", dtype="float32", model=copy.deepcopy(TINY_MODEL))
    cfg["serving"]["app"].update(prefill_buckets=[128, 256], decode_slots=4)
    return cfg


def tiny_cell(name: str, root=manifest.ROOT) -> manifest.Cell:
    """Cell `name` at tiny size, with a mix short enough for a test."""
    cell = manifest.cell(name, root)
    cell.config = tiny_config(cell.entry["config"], root)
    if cell.mix["kind"] == "files":
        cell.mix.update(clients=2, file_s=[4.0, 8.0], settle_s=2.0, tape_s=10.0,
                        start_stagger_s=1.0,
                        utterance_s={"median": 1.0, "sigma": 0.5, "lo": 0.4, "hi": 2.0},
                        request=dict(cell.mix["request"], max_segment_duration=2.0))
    else:
        cell.mix.update(streams=3, settle_s=2.0, drain_s=3.0, tape_s=10.0, start_offset_s=1.0,
                        utterance_s={"median": 0.8, "sigma": 0.3, "lo": 0.4, "hi": 1.2})
    cell.workload["check"].update(gap_per_tie_limit=1e-4, min_tokens=10)
    return cell
