"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

- the cell: its entry in ``workloads``, and ``workloads/<cell>.json``
  (what the harness needs beyond the manifest: the kernel probes' shapes,
  the correctness sample and limits);
- its configuration: ``configs/<config>.json`` (the file the manifest names),
  whose ``family`` names the model family ``families/<family>.py``: the
  program's config and width check, the weights handed to the program and
  the plain reference that judges it;
- its traffic mix: ``mixes/<traffic>.json``, whose ``kind`` names the
  generator ``traffic/<kind>.py``;
- each metric: ``metrics/<name>.py``, a module with ``read(reading)``.

A later cell, mix, kind, family or metric is added by adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    entry: dict  # the manifest's workloads entry
    workload: dict  # workloads/<cell>.json
    config: dict  # the configuration file
    mix: dict  # mixes/<traffic>.json
    end_to_end: list  # manifest metric entries this cell reports
    per_layer: list
    root: Path = ROOT

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def traffic(self):
        kind = self.mix["kind"]
        if not NAME.match(kind):
            raise ValueError(f"bad traffic kind {kind!r}")
        return _module(self.root / "gpubench" / "traffic" / f"{kind}.py",
                       f"gpubench_traffic_{kind}")

    def family(self):
        return family(self.config["family"], self.root)


def reporting(metrics: list, cell: str) -> list:
    """The metric entries a cell reports: those that list it, or that
    list no cells."""
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def manifest(root: Path = ROOT) -> dict:
    return _load_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> Cell:
    man = manifest(root)
    entries = {w["name"]: w for w in man["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in man["configs"]}
    conf_entry = configs[entry["config"]]
    here = root / "gpubench"
    config = _load_json(root / conf_entry["file"])
    return Cell(
        name=name,
        entry=entry,
        workload=_load_json(here / "workloads" / f"{name}.json"),
        config=config,
        mix=_load_json(here / "mixes" / f"{entry['traffic']}.json"),
        end_to_end=reporting(man["end_to_end"], name),
        per_layer=reporting(man["per_layer"], name),
        root=root,
    )


def metric_reader(name: str, root: Path = ROOT):
    """metrics/<name>.py's ``read``."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    return _module(root / "gpubench" / "metrics" / f"{name}.py",
                   "gpubench_metric_" + name.replace(".", "_").replace("-", "_")).read


def family(name: str, root: Path = ROOT):
    """families/<name>.py: ``program_config``, ``check_widths``,
    ``make_weights`` and ``reference``."""
    if not NAME.match(name):
        raise ValueError(f"bad family name {name!r}")
    return _module(root / "gpubench" / "families" / f"{name}.py",
                   "gpubench_family_" + name.replace(".", "_").replace("-", "_"))
