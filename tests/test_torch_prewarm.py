"""The prebuilt-library deploy path on the CPU, where there is no nvcc:
the kernel directory override (SONIC_KERNEL_DIR) of ops/_build.py and
native/, the built / loaded counts (nvcc a stand-in script that writes its
output file, the libraries stand-in files that are never run here),
tools/prewarm.py's staging and its two lines, a restart in a child
process that builds nothing, and tools/bench_warmup.py's JSON against the
keys of the JAX package's WARMUP_BENCH.json."""

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from sonicscribe_tpu_torch import native
from sonicscribe_tpu_torch.ops import _build
from sonicscribe_tpu_torch.tools import bench_warmup, prewarm
from test_torch_bench_tools import DEVICE_KEYS, TPU_PROBES, jax_artifact

ROOT = Path(__file__).resolve().parents[1]
# the JAX artifact's keys of its earlier rounds: a second run's variance and prose
WARMUP_TPU_ONLY = TPU_PROBES | {"variance_run2", "observed_range_note"}


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    """A checkout's build directories and a deploy directory under
    tmp_path; the override unset, the modules' caches and counts fresh."""
    ck = tmp_path / "checkout"
    monkeypatch.setattr(_build, "BUILD_DIR", ck / "kernels")
    monkeypatch.setattr(native, "BUILD_DIR", ck / "native")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_built", set())
    monkeypatch.setattr(_build, "library_counts", {"built": 0, "loaded": 0})
    monkeypatch.setattr(native, "library_counts", {"built": 0, "loaded": 0})
    monkeypatch.setenv(_build.KERNEL_DIR_ENV, "unset-below")
    monkeypatch.delenv(_build.KERNEL_DIR_ENV)
    return ck, tmp_path / "deploy"


def _stand_in(path: Path) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"stand-in for " + path.name.encode())
    return path


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """An nvcc that writes its -o file (and logs the source it compiled)."""
    log = tmp_path / "nvcc.log"
    script = tmp_path / "nvcc"
    script.write_text('#!/bin/sh\nout=""; while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then '
                      'out="$2"; shift; fi; last="$1"; shift; done\n'
                      f'echo "$last" >> {log}\necho built > "$out"\n')
    script.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(script))
    return log


def test_the_override_moves_both_directories(dirs, monkeypatch):
    ck, deploy = dirs
    assert _build.library_path("log_mel").parent == ck / "kernels"
    assert native.lib_path().parent == ck / "native"
    name = _build.library_path("log_mel").name
    monkeypatch.setenv("SONIC_KERNEL_DIR", str(deploy))
    assert _build.library_path("log_mel") == deploy / "kernels" / name  # same digest
    assert native.lib_path().parent == deploy / "native"


def test_build_and_load_count_built_and_prebuilt(dirs, fake_nvcc, monkeypatch):
    """A library the directory lacks is built (counted built), one it holds
    is loaded as it is (counted loaded); an edited source's digest is not
    there, so it is built, never skipped."""
    ck, deploy = dirs
    monkeypatch.setenv("SONIC_KERNEL_DIR", str(deploy))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: f"lib:{Path(path).name}")
    _stand_in(_build.library_path("log_mel"))
    assert _build.load("log_mel") == f"lib:{_build.library_path('log_mel').name}"
    assert _build.library_counts == {"built": 0, "loaded": 1}
    _build.load("decode_attention")
    assert _build.library_counts == {"built": 1, "loaded": 1}
    assert _build.library_path("decode_attention").read_text() == "built\n"
    _build.build()  # the three others, at once
    assert _build.library_counts == {"built": 4, "loaded": 1}
    assert sorted(Path(p).name for p in fake_nvcc.read_text().split()) == [
        "decode_attention.cu", "decode_glue.cu", "int4_matmul.cu", "int8_matmul.cu"]
    src = deploy / "csrc"
    src.mkdir()
    for path in _build.sources("log_mel"):
        (src / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC", src)
    (src / "log_mel.cu").write_text((src / "log_mel.cu").read_text() + "\n// edited\n")
    assert not _build.library_path("log_mel").exists()
    monkeypatch.setattr(_build, "_libs", {})
    _build.load("log_mel")
    assert _build.library_counts == {"built": 5, "loaded": 1}


def test_stage_copies_what_the_checkout_built_and_builds_the_rest(dirs, fake_nvcc, monkeypatch):
    ck, deploy = dirs
    monkeypatch.setenv("SONIC_KERNEL_DIR", "placeholder")  # restored after the test
    names = {k: _build.library_path(k).name for k in _build.KERNELS}
    for k in ("decode_attention", "int8_matmul"):
        _stand_in(ck / "kernels" / names[k])
    native_name = native.lib_path().name
    _stand_in(ck / "native" / native_name)
    done = prewarm.stage_libraries(str(deploy))
    assert os.environ["SONIC_KERNEL_DIR"] == str(deploy)
    assert sorted(done["copied"]) == sorted([names["decode_attention"], names["int8_matmul"],
                                             native_name])
    assert sorted(done["built"]) == sorted([names["log_mel"], names["int4_matmul"],
                                            names["decode_glue"]])
    assert done["kept"] == []
    for k, name in names.items():
        assert (deploy / "kernels" / name).exists(), k
    assert (deploy / "kernels" / names["int8_matmul"]).read_bytes().startswith(b"stand-in")
    assert (deploy / "native" / native_name).exists()
    again = prewarm.stage_libraries(str(deploy))
    assert again["copied"] == again["built"] == [] and len(again["kept"]) == 6


def test_prewarm_main_prints_jaxs_two_lines(dirs, capsys, monkeypatch):
    ck, deploy = dirs
    monkeypatch.setenv("SONIC_KERNEL_DIR", "placeholder")
    for k in _build.KERNELS:
        _stand_in(ck / "kernels" / _build.library_path(k).name)
    _stand_in(ck / "native" / native.lib_path().name)
    prewarm.main(["--model", "tiny-random", "--out", str(deploy), "--device", "cpu"])
    first, second = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"prewarm done: model=tiny-random quant=native shape=server "
                        r"build=\d+\.\ds warmup=\d+\.\ds saves=6 loads=0 store_files=6 -> "
                        + re.escape(str(deploy)), first), first
    assert second.startswith("deploy: ship this directory") and "SONIC_KERNEL_DIR" in second
    prewarm.main(["--model", "tiny-random", "--out", str(deploy), "--device", "cpu",
                  "--engine-shape", "bench-stream"])
    assert "saves=0 loads=0 store_files=6" in capsys.readouterr().out


_RESTART = r"""
import asyncio, json, numpy as np
from sonicscribe_tpu_torch import native
from sonicscribe_tpu_torch.ops import _build
from sonicscribe_tpu_torch.serve.runtime import build_runtime
engine, _vad, _info = build_runtime("tiny-random", device="cpu")
assert native.load() is not None
r = asyncio.run(engine.transcribe(np.zeros(8000, np.float32), 16000, max_new_tokens=4))
engine.shutdown()
print(json.dumps({"saves": _build.library_counts["built"] + native.library_counts["built"],
                  "loads": _build.library_counts["loaded"] + native.library_counts["loaded"],
                  "tokens": len(r.tokens)}))
"""


def test_a_restart_on_the_deploy_directory_builds_nothing(tmp_path):
    """prewarm's staging with g++ for the native library, then a server
    process on SONIC_KERNEL_DIR serving a request: nothing built, the
    native library loaded prebuilt (the kernel libraries run only on the
    card)."""
    if native.build() is None:
        pytest.skip("g++ unavailable")
    deploy = tmp_path / "deploy"
    env = dict(os.environ, SONIC_KERNEL_DIR=str(deploy))
    stage = ("import sys; from sonicscribe_tpu_torch import native; "
             "from sonicscribe_tpu_torch.ops import _build; "
             "_build.build = lambda names=(): None; "  # no nvcc here: the kernels are not staged
             "from sonicscribe_tpu_torch.tools import prewarm; "
             "sys.exit(0 if native.lib_path().name in "
             "str(prewarm.stage_libraries(sys.argv[1])) else 1)")
    subprocess.run([sys.executable, "-c", stage, str(deploy)], check=True, cwd=ROOT, env=env,
                   timeout=120)
    out = subprocess.run([sys.executable, "-c", _RESTART], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["saves"] == 0 and got["loads"] == 1 and 1 <= got["tokens"] <= 4, got


def test_bench_warmup_keeps_jaxs_keys():
    """Both modes in their children (tiny f32 on the CPU): the JAX
    artifact's keys, each mode's keys JAX's; the cold mode builds the
    native library, the restart builds nothing and loads it."""
    out = bench_warmup.bench(True, "cpu")
    want = jax_artifact("WARMUP_BENCH.json")
    assert WARMUP_TPU_ONLY <= set(want)
    assert set(want) - WARMUP_TPU_ONLY <= set(out)
    assert DEVICE_KEYS <= set(out) and out["backend"] == "cpu" and out["model"] == "tiny"
    for mode in ("fast", "restart"):
        assert set(out[mode]) == set(want[mode]), out[mode]
        assert out[mode]["mode"] == mode and out[mode]["ready_s"] >= 0
    assert out["fast"]["saves"] >= 1 and out["fast"]["loads"] == 0
    assert out["restart"]["saves"] == 0 and out["restart"]["loads"] >= 1
