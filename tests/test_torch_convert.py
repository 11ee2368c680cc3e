"""Port parity for the checkpoint tools on the CPU: the port's own
safetensors reader and writer against the safetensors package; the port's
HF -> native converter against the JAX package's on the JAX exporter's
fixture (native and int8), a BF16 source, the port's exporter read back by
the JAX converter; the JAX package's converter and runbook cases
(tests/test_convert_hf.py, tests/test_verify_checkpoint.py) run against
the port's tools; load_checkpoint on an HF directory."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import load_file as torch_load_file
from safetensors.torch import save_file as torch_save_file

from sonicscribe_tpu.models import tiny as tiny_jax
from sonicscribe_tpu.models.glm_asr import init_params
from sonicscribe_tpu.tools import convert_weights as convert_jax
from sonicscribe_tpu.tools.export_hf import export_hf_checkpoint as export_hf_jax
from sonicscribe_tpu.tools.export_hf import make_test_tokenizer
from sonicscribe_tpu_torch.audio.wav import write_wav
from sonicscribe_tpu_torch.models import tiny
from sonicscribe_tpu_torch.models.tokenizer import HFTokenizer
from sonicscribe_tpu_torch.models.weights import load_checkpoint, params_from_jax
from sonicscribe_tpu_torch.tools import safetensors_io, torch_reference
from sonicscribe_tpu_torch.tools.convert_weights import (
    HF_NAME_MAP,
    TOKENIZER_FILES,
    _flatten,
    cfg_from_hf_config,
    convert_hf_checkpoint,
    expected_shapes,
)
from sonicscribe_tpu_torch.tools.export_hf import export_hf_checkpoint
from sonicscribe_tpu_torch.tools.verify_checkpoint import main as verify_main
from sonicscribe_tpu_torch.tools.verify_checkpoint import verify

quiet = dict(progress=lambda _m: None)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """The JAX package's fixture: tiny() f32 from PRNGKey(7) through its
    exporter (F32 safetensors, config.json, generation_config.json) and a
    trained test tokenizer. -> (JAX tree, directory)."""
    params = init_params(tiny_jax(), jax.random.PRNGKey(7), dtype=jnp.float32)
    d = str(tmp_path_factory.mktemp("hf_fixture"))
    export_hf_jax(params, tiny_jax(), d)
    make_test_tokenizer(d, vocab_size=tiny_jax().decoder.vocab_size, cfg=tiny_jax())
    return params, d


def _npz(path: str) -> dict:
    with np.load(os.path.join(path, "params.npz")) as z:
        return {k: z[k] for k in z.files}


def _meta(path: str) -> dict:
    with open(os.path.join(path, "sonicscribe_config.json")) as f:
        return json.load(f)


def _same_checkpoint(a: str, b: str) -> None:
    """Two native directories: the same arrays key by key (dtype and bits),
    the same config json, the same tokenizer files. Never the npz bytes:
    zip entry order and timestamps may differ."""
    za, zb = _npz(a), _npz(b)
    assert sorted(za) == sorted(zb)
    for k in za:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    assert _meta(a) == _meta(b)
    ta, tb = (sorted(os.listdir(os.path.join(p, "tokenizer")))
              if os.path.isdir(os.path.join(p, "tokenizer")) else [] for p in (a, b))
    assert ta == tb
    for f in ta:
        with open(os.path.join(a, "tokenizer", f), "rb") as x, \
                open(os.path.join(b, "tokenizer", f), "rb") as y:
            assert x.read() == y.read(), f


# ---------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------

ARRAYS = {
    "F32": lambda rng: rng.standard_normal((3, 4)).astype(np.float32),
    "F16": lambda rng: rng.standard_normal((5,)).astype(np.float16),
    "I8": lambda rng: rng.integers(-128, 128, (2, 3, 4)).astype(np.int8),
    "I32": lambda rng: rng.integers(-2**31, 2**31, (7,)).astype(np.int32),
    "I64": lambda rng: rng.integers(-2**40, 2**40, (2, 2)).astype(np.int64),
}


@pytest.mark.parametrize("dtype", list(ARRAYS))
def test_safetensors_reader_and_writer_match_the_package(dtype, tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"a.weight": ARRAYS[dtype](rng), "b": ARRAYS[dtype](rng),
              "scalar": np.array(ARRAYS[dtype](rng).ravel()[0])}
    theirs, ours = str(tmp_path / "theirs.safetensors"), str(tmp_path / "ours.safetensors")
    np_save_file(arrays, theirs, metadata={"format": "np"})
    got = safetensors_io.load_file(theirs)
    assert safetensors_io.read_shapes(theirs) == {k: v.shape for k, v in arrays.items()}
    safetensors_io.save_file(arrays, ours, metadata={"format": "np"})
    back = np_load_file(ours)
    for k, v in arrays.items():
        assert got[k].numpy().dtype == v.dtype and back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v)
        np.testing.assert_array_equal(back[k], v)


def test_safetensors_bf16_both_ways(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {"w": torch.randn((4, 6), generator=g).to(torch.bfloat16),
               "x": torch.randn((3,), generator=g), "q": torch.tensor([1, -2], dtype=torch.int8)}
    theirs, ours = str(tmp_path / "theirs.safetensors"), str(tmp_path / "ours.safetensors")
    torch_save_file(tensors, theirs)
    got = safetensors_io.load_file(theirs)
    safetensors_io.save_file(tensors, ours)
    back = torch_load_file(ours)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype == back[k].dtype, k
        assert torch.equal(got[k], v) and torch.equal(back[k], v), k
    assert safetensors_io.read_shapes(ours) == {"q": (2,), "w": (4, 6), "x": (3,)}


# ---------------------------------------------------------------------
# the converter against the JAX package's
# ---------------------------------------------------------------------


@pytest.mark.parametrize("int8", [False, True])
def test_convert_matches_jax_bit_for_bit(hf_dir, tmp_path, int8):
    """Each package's converter on the JAX exporter's fixture: the same npz
    keys, every array equal in dtype and bits (bf16 leaves as uint16 views,
    int8 codes and float32 scales), sonicscribe_config.json equal, the
    tokenizer files equal."""
    _, d = hf_dir
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    assert convert_hf_checkpoint(d, ours, int8=int8, **quiet) == tiny()
    convert_jax.convert_hf_checkpoint(d, theirs, int8=int8, **quiet)
    _same_checkpoint(ours, theirs)
    assert os.path.exists(os.path.join(ours, "tokenizer", "tokenizer.json"))
    z = _npz(ours)
    if int8:
        assert z["decoder/layers/qkv_w/q"].dtype == np.int8
        assert z["decoder/layers/qkv_w/scale"].dtype == np.float32
    assert _meta(ours)["dtypes"]["decoder/embed"] == "bfloat16"


def _bf16_copy(hf_dir: str, dst: str) -> str:
    """The fixture's tensors cast to bf16 (round to nearest even, as the
    converters cast) and written as BF16 safetensors by the package."""
    shutil.copytree(hf_dir, dst)
    sd = safetensors_io.load_file(os.path.join(hf_dir, "model.safetensors"))
    torch_save_file({k: v.to(torch.bfloat16) for k, v in sd.items()},
                    os.path.join(dst, "model.safetensors"))
    return dst


def test_bf16_safetensors_source_converts_to_the_f32_sources_tree(hf_dir, tmp_path):
    """HF releases of this size store BF16: a BF16 source converts to the
    bits of the F32 source's output, and to the JAX converter's output on
    the same BF16 source."""
    _, d = hf_dir
    bf16_dir = _bf16_copy(d, str(tmp_path / "hf_bf16"))
    assert {v.dtype for v in safetensors_io.load_file(
        os.path.join(bf16_dir, "model.safetensors")).values()} == {torch.bfloat16}
    convert_hf_checkpoint(d, str(tmp_path / "from_f32"), **quiet)
    convert_hf_checkpoint(bf16_dir, str(tmp_path / "from_bf16"), **quiet)
    convert_jax.convert_hf_checkpoint(bf16_dir, str(tmp_path / "jax_from_bf16"), **quiet)
    _same_checkpoint(str(tmp_path / "from_f32"), str(tmp_path / "from_bf16"))
    _same_checkpoint(str(tmp_path / "from_bf16"), str(tmp_path / "jax_from_bf16"))


_JAX_LOADER_ALONE = r"""
import sys
from sonicscribe_tpu.tools.convert_weights import _load_hf_state_dict
assert "ml_dtypes" not in sys.modules
_load_hf_state_dict(sys.argv[1])
"""


def test_jax_loader_reads_bf16_only_where_ml_dtypes_is_loaded(hf_dir, tmp_path):
    """The reference's loader (safetensors.numpy.load_file) takes numpy's
    name 'bfloat16', which exists only once ml_dtypes (JAX's) is imported:
    its convert_hf_checkpoint imports jax.numpy first and reads BF16 (the
    test above), but its _load_hf_state_dict called in a process without
    JAX raises. The port reads BF16 itself (tools/safetensors_io.py)."""
    _, d = hf_dir
    bf16_dir = _bf16_copy(d, str(tmp_path / "hf_bf16"))
    out = subprocess.run([sys.executable, "-c", _JAX_LOADER_ALONE, bf16_dir],
                         capture_output=True, text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode != 0
    assert "data type 'bfloat16' not understood" in out.stderr, out.stderr[-2000:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_export_read_back_by_the_jax_converter(tmp_path, dtype):
    """The port's exporter on a tree carried over from JAX: JAX's converter
    (F32) and the port's (F32 and BF16) read it back to the tree, cast to
    bf16. The untied, no-bias variant (a real lm_head, no qkv bias
    tensors) is derived from config.json."""
    base = tiny_jax()
    cfg_j = dataclasses.replace(base, decoder=dataclasses.replace(
        base.decoder, tie_embeddings=False, qkv_bias=False))
    params_j = init_params(cfg_j, jax.random.PRNGKey(5), dtype=jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")
    cfg = dataclasses.replace(tiny(), decoder=dataclasses.replace(
        tiny().decoder, tie_embeddings=False, qkv_bias=False))
    hf = str(tmp_path / "hf")
    export_hf_checkpoint(params, cfg, hf, dtype=dtype)
    names = safetensors_io.read_shapes(os.path.join(hf, "model.safetensors"))
    assert "lm_head.weight" in names and not any("qkv_proj.bias" in n for n in names)
    assert cfg_from_hf_config(hf) == cfg
    ours = str(tmp_path / "port")
    assert convert_hf_checkpoint(hf, ours, cfg=None, **quiet) == cfg
    z = _npz(ours)
    want = _flatten(jax.tree.map(lambda x: np.asarray(
        jnp.asarray(x, jnp.bfloat16)).view(np.uint16), params_j))
    want["decoder/layers/qkv_b"] = np.zeros_like(want["decoder/layers/qkv_b"])
    assert sorted(z) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(z[k], want[k], err_msg=k)
    if dtype == torch.float32:
        theirs = str(tmp_path / "jax")
        convert_jax.convert_hf_checkpoint(hf, theirs, cfg=None, **quiet)
        _same_checkpoint(ours, theirs)


def test_synthetic_checkpoint_has_every_mapped_name(hf_dir, tmp_path):
    params_j, _ = hf_dir
    params = params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")
    export_hf_checkpoint(params, tiny(), str(tmp_path))
    names = safetensors_io.read_shapes(os.path.join(str(tmp_path), "model.safetensors"))
    for ours, theirs in HF_NAME_MAP.items():
        if "@{L}" in ours:
            n = tiny().encoder.n_layers if ours.startswith("encoder") else tiny().decoder.n_layers
            for layer in range(n):
                assert theirs.replace("{L}", str(layer)) in names, theirs
        else:
            assert theirs in names, theirs


def test_loaded_checkpoint_serves_the_hf_tokenizer(hf_dir, tmp_path):
    _, d = hf_dir
    out = str(tmp_path / "native")
    convert_hf_checkpoint(d, out, **quiet)
    cfg, params, tok = load_checkpoint(out, device="cpu")
    assert cfg == tiny() and isinstance(tok, HFTokenizer)
    assert tok.eos_id == cfg.eos_id and tok.pad_id == cfg.pad_id
    assert params["decoder"]["embed"].dtype == torch.bfloat16
    assert sorted(os.listdir(os.path.join(out, "tokenizer"))) == sorted(
        f for f in TOKENIZER_FILES if os.path.exists(os.path.join(d, f)))


def test_load_checkpoint_on_an_hf_directory_names_the_converter(hf_dir):
    _, d = hf_dir
    with pytest.raises(FileNotFoundError,
                       match="python -m sonicscribe_tpu_torch.tools.convert_weights"):
        load_checkpoint(d, device="cpu")


# ---------------------------------------------------------------------
# the JAX package's converter and runbook cases, on the port's tools
# ---------------------------------------------------------------------


def test_cfg_derivation_roundtrips_exactly(hf_dir):
    _, d = hf_dir
    assert cfg_from_hf_config(d) == tiny()


def test_cfg_derivation_fails_loudly_listing_missing_fields(tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_type": "glm-asr", "audio_config": {},
                   "text_config": {"vocab_size": 100}}, f)
    with pytest.raises(ValueError) as e:
        cfg_from_hf_config(str(tmp_path))
    msg = str(e.value)
    assert "audio:" in msg and "text:" in msg
    assert "num_mel_bins" in msg and "hidden_size" in msg


def test_convert_with_derived_config(hf_dir, tmp_path):
    _, d = hf_dir
    out = str(tmp_path / "native")
    assert convert_hf_checkpoint(d, out, cfg=None, **quiet) == tiny()
    cfg, params, _ = load_checkpoint(out, device="cpu")
    assert cfg == tiny()
    flat = _flatten(params)
    for k, shape in expected_shapes(cfg).items():
        assert tuple(flat[k].shape) == shape, k


def test_explicit_cfg_disagreement_raises_with_diff(hf_dir, tmp_path):
    _, d = hf_dir
    wrong = dataclasses.replace(tiny(), decoder=dataclasses.replace(tiny().decoder, n_kv_heads=4))
    with pytest.raises(ValueError) as e:
        convert_hf_checkpoint(d, str(tmp_path / "x"), wrong, **quiet)
    assert "decoder.n_kv_heads" in str(e.value) and "given=4" in str(e.value)


def test_missing_hf_tensor_raises(hf_dir, tmp_path):
    _, d = hf_dir
    broken = str(tmp_path / "broken_hf")
    shutil.copytree(d, broken)
    path = os.path.join(broken, "model.safetensors")
    sd = safetensors_io.load_file(path)
    victim = "audio_proj.linear_1.weight"
    sd["audio_proj.proj_in.weight"] = sd.pop(victim)
    safetensors_io.save_file(sd, path)
    with pytest.raises(KeyError) as e:
        convert_hf_checkpoint(broken, str(tmp_path / "y"), tiny(), **quiet)
    assert victim in str(e.value)


def test_unconsumed_hf_tensors_are_reported(hf_dir, tmp_path):
    _, d = hf_dir
    extra = str(tmp_path / "extra_hf")
    shutil.copytree(d, extra)
    path = os.path.join(extra, "model.safetensors")
    sd = safetensors_io.load_file(path)
    sd["model.layers.0.mystery_gate.weight"] = torch.zeros((4, 4))
    sd["model.rotary_emb.inv_freq"] = torch.zeros((8,))  # a derived buffer: not reported
    safetensors_io.save_file(sd, path)
    msgs: list[str] = []
    convert_hf_checkpoint(extra, str(tmp_path / "z"), tiny(), progress=msgs.append)
    warn = [m for m in msgs if m.startswith("WARNING")]
    assert len(warn) == 1 and "mystery_gate" in warn[0] and "inv_freq" not in warn[0]


def test_verify_runbook_passes_on_the_fixture(hf_dir, tmp_path, capsys):
    """derive -> convert -> load -> twin -> mel -> golden WAV, on the CPU;
    the CLI exits 0."""
    _, d = hf_dir
    sr = 16000
    t = np.arange(sr) / sr
    wav = str(tmp_path / "golden.wav")
    with open(wav, "wb") as f:
        f.write(write_wav((0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32), sr))
    report = verify(d, out=str(tmp_path / "native"), wavs=[wav], device="cpu")
    by_step = {r["step"]: r for r in report}
    for step in ("derive", "convert", "load", "twin", "mel", "wav[0]"):
        assert by_step[step]["status"] == "ok", by_step.get(step, report)
    assert "token-exact over" in by_step["twin"]["detail"]
    assert verify_main([d, "--out", str(tmp_path / "native2"), "--device", "cpu"]) == 0
    assert "checkpoint verification: PASSED" in capsys.readouterr().out


def test_verify_runbook_int8_skips_the_twin(hf_dir, tmp_path):
    _, d = hf_dir
    report = verify(d, out=str(tmp_path / "native"), int8=True, device="cpu")
    by_step = {r["step"]: r for r in report}
    assert by_step["twin"]["status"] == "skipped"
    assert by_step["load"]["status"] == "ok" and not [r for r in report if r["status"] == "FAIL"]


def test_verify_twin_gate_is_not_vacuous(hf_dir, tmp_path, monkeypatch):
    """One perturbed tensor on the reference's side (the final norm's
    scale negated: every logit flips sign) fails the twin step, and the
    CLI exits 1."""
    _, d = hf_dir
    real = torch_reference.transcribe_torch

    def perturbed(params, cfg, *args, **kwargs):
        params = dict(params, decoder=dict(params["decoder"]))
        params["decoder"]["ln_f_scale"] = -np.asarray(params["decoder"]["ln_f_scale"])
        return real(params, cfg, *args, **kwargs)

    monkeypatch.setattr(torch_reference, "transcribe_torch", perturbed)
    report = verify(d, out=str(tmp_path / "native"), device="cpu")
    by_step = {r["step"]: r for r in report}
    assert by_step["twin"]["status"] == "FAIL", report
    assert verify_main([d, "--out", str(tmp_path / "native2"), "--device", "cpu"]) == 1
