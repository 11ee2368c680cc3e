"""BENCHMARK.json keeps to the contract's shape, and everything is found by name."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from gpubench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_names_units_and_keys():
    man = manifest.manifest()
    assert set(man) == KEYS
    assert man["command"][0] == "python3" and len(man["command"]) <= 32
    assert all(_line(w) for w in man["command"])
    assert 1 <= man["run_seconds"] <= 51
    names = set()
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("gpubench/") and (manifest.ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    metrics = man["end_to_end"] + man["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                 "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert (manifest.ROOT / "gpubench" / "metrics" / f"{m['name']}.py").is_file()
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
    for w in man["workloads"]:
        cell = manifest.cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        assert all(m["moves"] in reported for m in cell.per_layer)
    assert len(json.dumps(man)) < 64 * 1024


def test_configs_keep_the_programs_widths():
    for w in manifest.manifest()["workloads"]:
        cfg = manifest.cell(w["name"]).config
        family = manifest.family(cfg["family"])
        family.check_widths(cfg, family.program_config(cfg))
    cfg = manifest.cell("nano-bf16.files-novad").config
    cfg["model"]["decoder"] = dict(cfg["model"]["decoder"], ffn_hidden=5505)
    with pytest.raises(ValueError, match="differs"):
        family.check_widths(cfg, family.program_config(cfg))


def test_a_new_cell_mix_kind_and_metric_are_found_by_adding_files(tmp_path):
    shutil.copytree(manifest.ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = manifest.manifest()
    g = tmp_path / "gpubench"
    cfg = json.loads((g / "configs" / "nano-bf16.json").read_text())
    cfg["name"] = "nano-new"
    (g / "configs" / "nano-new.json").write_text(json.dumps(cfg))
    (g / "mixes" / "bursts.json").write_text(json.dumps({"kind": "bursty", "streams": 3}))
    (g / "traffic" / "bursty.py").write_text("KIND = 'bursty'\n\nasync def run(ctx):\n"
                                             "    return {}\n")
    (g / "workloads" / "nano-new.bursts.json").write_text(json.dumps({"check": {}}))
    (g / "metrics" / "burst_p99_ms.py").write_text("def read(r):\n    return 42.0\n")
    man["configs"].append({"name": "nano-new", "source": "https://example.org/x",
                           "file": "gpubench/configs/nano-new.json", "reduced": [],
                           "why": "a new one"})
    man["workloads"].append({"name": "nano-new.bursts", "config": "nano-new",
                             "traffic": "bursts", "chips": 1, "why": "bursts"})
    man["end_to_end"].append({"name": "burst_p99_ms", "unit": "ms", "better": "lower",
                              "bound": 0.05, "source": "host_clock",
                              "workloads": ["nano-new.bursts"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = manifest.cell("nano-new.bursts", root=tmp_path)
    assert cell.config["name"] == "nano-new" and cell.mix["kind"] == "bursty"
    assert cell.traffic().KIND == "bursty"
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "burst_p99_ms"]
    assert manifest.metric_reader("burst_p99_ms", root=tmp_path)(None) == 42.0
    with pytest.raises(KeyError):
        manifest.cell("nano-missing.bursts", root=tmp_path)
    assert cell.family().__name__ == "gpubench_family_glm_asr"
    with pytest.raises(FileNotFoundError):
        manifest.family("missing_family", root=tmp_path)
    with pytest.raises(ValueError):
        manifest.family("../glm_asr", root=tmp_path)
