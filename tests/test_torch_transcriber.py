"""Port parity: the PyTorch Transcriber vs the JAX Transcriber on tiny() f32
with the same weights (carried over bit-exact): same tokens, same text."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sonicscribe_tpu.engine.transcriber import Transcriber as TranscriberJax
from sonicscribe_tpu.models import tiny as tiny_jax
from sonicscribe_tpu.models.glm_asr import init_params
from sonicscribe_tpu.models.tokenizer import ByteTokenizer as ByteTokenizerJax
from sonicscribe_tpu_torch.engine.transcriber import Transcriber
from sonicscribe_tpu_torch.models import tiny
from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
from sonicscribe_tpu_torch.models.weights import params_from_jax

BUCKETS = (128, 256)  # what tiny-random serves


@pytest.fixture(scope="module")
def pair():
    cfg_j = tiny_jax()
    # scaled so the random model's greedy tokens vary: at init scale it
    # repeats one token, which would make token parity a weak check
    params_j = jax.tree.map(
        lambda x: x * 4.0, init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    )
    jax_tr = TranscriberJax(cfg_j, params_j, ByteTokenizerJax(cfg_j), prefill_buckets=BUCKETS)
    cfg = tiny()
    params = params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")
    port_tr = Transcriber(cfg, params, ByteTokenizer(cfg), prefill_buckets=BUCKETS)
    return jax_tr, port_tr


def _audio(seconds, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.3 * np.sin(2 * np.pi * 300 * t) * (1 + np.sin(2 * np.pi * 2 * t))
    return (x + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.mark.parametrize(
    "seconds,sr,hotwords",
    [
        (1.0, 16000, None),
        (0.8, 44100, ["hello", "World"]),
        (3.1, 16000, None),  # 310 frames: over the largest bucket, clamped
    ],
)
def test_same_tokens_and_text(pair, seconds, sr, hotwords):
    jax_tr, port_tr = pair
    audio = _audio(seconds, sr, seed=int(seconds * 10))
    want = jax_tr.transcribe(audio, sr, max_new_tokens=16, hotwords=hotwords)
    got = port_tr.transcribe(audio, sr, max_new_tokens=16, hotwords=hotwords)
    assert len(set(want.tokens.tolist())) > 3
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.text == want.text
    assert got.audio_duration_s == pytest.approx(want.audio_duration_s)
    assert got.timings.keys() == want.timings.keys()
    assert got.timings["mel_bucket"] == want.timings["mel_bucket"]
