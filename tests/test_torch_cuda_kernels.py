"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a card every test skips. The file imports neither
JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from sonicscribe_tpu_torch.audio.mel import MelConfig, device_tables, reflect_pad
from sonicscribe_tpu_torch.device import resolve_device
from sonicscribe_tpu_torch.models import glm_asr as tm
from sonicscribe_tpu_torch.models.config import tiny
from sonicscribe_tpu_torch.models.weights import init_random
from sonicscribe_tpu_torch.ops import _build
from sonicscribe_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
)
from sonicscribe_tpu_torch.ops.mel import log_mel_frames, log_mel_frames_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    # full float32: the plain mel's conv1d would otherwise run in cuDNN's TF32
    return resolve_device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [200, 803])
def test_decode_attention_kernel(cuda, dtype, M):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((3, 16, 128), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, 3, M, 4, 128), generator=g, device=cuda).to(dtype)[1]
    v = torch.randn((2, 3, M, 4, 128), generator=g, device=cuda).to(dtype)[1]
    lens = torch.tensor([0, M // 2, M], dtype=torch.int32, device=cuda)
    before = _build.launch_counts["decode_attention"]
    got = decode_attention(q, k, v, lens)
    assert _build.launch_counts["decode_attention"] == before + 1
    want = decode_attention_plain(q, k, v, lens)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)  # float32 sums, other order


def test_log_mel_kernel(cuda):
    cfg = MelConfig()
    rng = np.random.default_rng(0)
    x = torch.from_numpy((0.1 * rng.standard_normal(16000 * 3 + 77)).astype(np.float32))
    padded, nf = reflect_pad(x.to(cuda), cfg)
    basis, fb = device_tables(cfg, cuda)
    before = _build.launch_counts["log_mel"]
    got = log_mel_frames(padded, basis, fb, nf, cfg.hop_length)
    assert _build.launch_counts["log_mel"] == before + 1
    want = log_mel_frames_plain(padded, basis, fb, nf, cfg.hop_length)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)  # float32 DFT sums


def test_greedy_generate_card_matches_cpu(cuda):
    cfg = tiny()
    params = init_random(cfg, seed=3, dtype=torch.float32, device="cpu")

    def scaled(tree, device):  # x4 so the random model's tokens vary
        if isinstance(tree, dict):
            return {k: scaled(v, device) for k, v in tree.items()}
        return (tree * 4.0).to(device)

    on_card, on_cpu = scaled(params, cuda), scaled(params, "cpu")
    rng = np.random.default_rng(1)
    embeds = torch.from_numpy((0.5 * rng.standard_normal((2, 12, 128))).astype(np.float32))
    length = torch.tensor([12, 9], dtype=torch.int32)
    want, _ = tm.greedy_generate(on_cpu, cfg, embeds, length, 16)
    got, _ = tm.greedy_generate(on_card, cfg, embeds.to(cuda), length.to(cuda), 16)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 16, 128), device=cuda, dtype=torch.float16)
    k = torch.zeros((1, 64, 4, 128), device=cuda, dtype=torch.float16)
    lens = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        decode_attention(q, k, k, lens)
    with pytest.raises(ValueError):
        decode_attention(q.float(), k.float(), k.float(), lens.cpu())
