"""What the benchmark loads: never JAX or the JAX package; the reference not the port."""

from __future__ import annotations

import json
import re
import subprocess
import sys

from gpubench import manifest

ROOT = str(manifest.ROOT)

_ALL = r"""
import importlib.util, json, sys
from pathlib import Path
sys.path.insert(0, ROOT)
import gpubench.run, gpubench.harness, gpubench.probes, gpubench.system
from gpubench import manifest
from gpubench.tools import calibrate
for sub in ("metrics", "traffic", "families"):
    for p in sorted((Path(ROOT) / "gpubench" / sub).glob("*.py")):
        spec = importlib.util.spec_from_file_location("m_" + p.stem.replace(".", "_"), p)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
RUN
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

_TINY_RUN = r"""
import time
from gpubench import harness
from gpubench.tests.tiny import tiny_cell
res = harness.run_cell(tiny_cell("nano-bf16.files-novad"), 7, 3.0, False, "cpu", time.perf_counter())
assert res["correct"], res
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.replace("ROOT", repr(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_benchmark_loads_no_jax_nor_the_jax_package():
    loaded = _top_level(_ALL.replace("RUN", _TINY_RUN))
    assert not loaded & {"jax", "jaxlib", "flax", "sonicscribe_tpu"}
    assert "sonicscribe_tpu_torch" in loaded  # names are compared whole


def test_the_reference_loads_nothing_of_the_port():
    code = ("import json, sys; sys.path.insert(0, ROOT)\n"
            "import gpubench.reference.check, gpubench.reference.model\n"
            "from gpubench import manifest\n"
            "from gpubench.tests.tiny import tiny_config\n"
            "manifest.family('glm_asr').reference(tiny_config(), 1, 'cpu')\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = _top_level(code)
    assert not loaded & {"jax", "jaxlib", "flax", "sonicscribe_tpu", "sonicscribe_tpu_torch"}


def test_only_the_glm_asr_family_reaches_its_reference_and_weights():
    """The harness reaches a model's weights and reference through its family:
    outside families/glm_asr.py and the tests, nothing imports
    reference/model.py or reference/weights.py's make_weights."""
    here = manifest.ROOT / "gpubench"
    pattern = re.compile(r"^\s*(?:from|import)\s[^\n]*(?:reference\.model\b|reference import"
                         r"[^\n]*\bmodel\b|\bmake_weights\b)|\bweights\.make_weights\b",
                         re.MULTILINE)
    found = [str(p.relative_to(here)) for p in sorted(here.rglob("*.py"))
             if p.relative_to(here).parts[0] != "tests"
             and p.relative_to(here).as_posix() not in ("families/glm_asr.py",
                                                        "reference/weights.py")
             and pattern.search(p.read_text())]
    assert found == []


def test_without_a_card_run_exits_nonzero_and_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "nano-bf16.files-novad",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_port_run_exits_nonzero(tmp_path):
    import shutil

    shutil.copytree(manifest.ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "nano-bf16.files-novad",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
