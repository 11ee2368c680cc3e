"""The port's golden-fixture generator against the JAX package's (CPU).

Both write tone / noise / hotword fixtures from the same seed. The JAX
generator draws its tiny f32 tree from PRNGKey(seed); the port takes that
tree (numpy leaves) as `params`. Ids and tokens must be equal, the mel
within 1e-3 (the port's plain log-mel against the JAX conv path) and the
encoder output within 2e-4 (float32 convs and products on another mel)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sonicscribe_tpu.models import tiny as tiny_jax
from sonicscribe_tpu.models.glm_asr import init_params
from sonicscribe_tpu.tools.golden import generate as generate_jax
from sonicscribe_tpu_torch.tools.golden import CASES, generate

MEL_TOL = 1e-3
ENC_TOL = 2e-4
SEED = 7


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    want_dir = tmp_path_factory.mktemp("golden_jax")
    got_dir = tmp_path_factory.mktemp("golden_port")
    want = generate_jax(str(want_dir), seed=SEED)
    params = jax.tree.map(
        np.asarray, init_params(tiny_jax(), jax.random.PRNGKey(SEED), dtype=jnp.float32))
    got = generate(str(got_dir), seed=SEED, params=params, device="cpu")
    return want_dir, got_dir, want, got


def test_manifest_equals_jax(fixtures):
    want_dir, got_dir, want, got = fixtures
    assert got == want
    assert json.loads((got_dir / "manifest.json").read_text()) == json.loads(
        (want_dir / "manifest.json").read_text())
    assert [c["name"] for c in got["cases"]] == [c[0] for c in CASES]


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_case_arrays_match_jax(fixtures, name):
    want_dir, got_dir, _, _ = fixtures
    w, g = np.load(want_dir / f"{name}.npz"), np.load(got_dir / f"{name}.npz")
    assert sorted(g.files) == sorted(w.files)
    np.testing.assert_array_equal(g["audio"], w["audio"])
    for key in ("prefix_ids", "suffix_ids", "tokens"):
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert g["tokens"].dtype == w["tokens"].dtype == np.int32
    assert g["mel"].shape == w["mel"].shape
    np.testing.assert_allclose(g["mel"], w["mel"], atol=MEL_TOL, rtol=0)
    assert g["encoder_out"].shape == w["encoder_out"].shape
    np.testing.assert_allclose(g["encoder_out"], w["encoder_out"], atol=ENC_TOL, rtol=0)


def test_own_tree_without_params(tmp_path):
    """Without a tree the port draws its own tiny tree from the seed: the
    same fixtures twice, 16 tokens or fewer (EOS ends a case early)."""
    a = generate(str(tmp_path / "a"), seed=3, device="cpu")
    b = generate(str(tmp_path / "b"), seed=3, device="cpu")
    assert a == b and all(0 < c["n_tokens"] <= 16 for c in a["cases"])
    for name, _, _ in CASES:
        x, y = np.load(tmp_path / "a" / f"{name}.npz"), np.load(tmp_path / "b" / f"{name}.npz")
        for key in x.files:
            np.testing.assert_array_equal(x[key], y[key], err_msg=f"{name} {key}")
