"""Golden-data generator: dumps reference fixtures for regression testing.

The port's counterpart of the JAX package's ``tools/golden.py``. It writes
the same fixtures: ``tone``, ``noise`` and ``hotword`` ``.npz`` files
(audio, mel, encoder_out, prefix / suffix ids, 16 greedy tokens) and
``manifest.json``. The mel comes from the port's ``audio/mel.py`` (the
log-mel kernel on the card, its plain version on the CPU); the encoder
output and the tokens from the independent ``tools/torch_reference.py``.

The port cannot draw JAX's PRNGKey numbers, so ``generate`` takes a
parameter tree in the JAX layout (numpy leaves, e.g. a JAX tree through
``jax.tree.map(np.asarray, ...)``): with the JAX package's tree for a seed
it writes that package's fixtures. Without one it draws the port's own
tiny f32 tree from `seed` (on the CPU, so that the tree does not depend on
the device).

Usage:
    python -m sonicscribe_tpu_torch.tools.golden <out_dir> [--seed 7] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

CASES = (("tone", 0.6, None), ("noise", 0.4, None), ("hotword", 0.5, ["golden", "fixture"]))


def generate(out_dir: str, seed: int = 7, params=None, device=None) -> dict:
    """Write the fixtures into out_dir -> the manifest. params: a tiny tree
    in the JAX layout with numpy leaves (None: the port's own from seed);
    device: where the mel is computed (the card unless 'cpu')."""
    from sonicscribe_tpu_torch.audio.mel import MelConfig, log_mel_spectrogram
    from sonicscribe_tpu_torch.device import resolve_device
    from sonicscribe_tpu_torch.models.config import tiny
    from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer, build_prompt
    from sonicscribe_tpu_torch.models.weights import init_random
    from sonicscribe_tpu_torch.tools.torch_reference import encode_audio_torch, transcribe_torch

    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    cfg = tiny()
    if params is None:
        tree = init_random(cfg, seed, dtype=torch.float32, device="cpu")
        params = _to_numpy(tree)
    tok = ByteTokenizer(cfg)

    rng = np.random.default_rng(seed)
    sr = 16000
    manifest = {"seed": seed, "cases": []}
    for name, seconds, hotwords in CASES:
        t = np.arange(int(sr * seconds)) / sr
        audio = (
            0.3 * np.sin(2 * np.pi * (300 + 100 * len(name)) * t)
            + 0.03 * rng.standard_normal(len(t))
        ).astype(np.float32)
        mel = log_mel_spectrogram(audio, MelConfig(), device=device).cpu().numpy()
        prompt = build_prompt(tok, cfg, hotwords=hotwords)
        enc = encode_audio_torch(params, cfg, mel).numpy()
        tokens = transcribe_torch(params, cfg, mel, prompt.prefix_ids, prompt.suffix_ids, 16)
        np.savez(
            os.path.join(out_dir, f"{name}.npz"),
            audio=audio,
            mel=mel,
            encoder_out=enc,
            prefix_ids=prompt.prefix_ids,
            suffix_ids=prompt.suffix_ids,
            tokens=np.asarray(tokens, np.int32),
        )
        manifest["cases"].append(
            {"name": name, "seconds": seconds, "hotwords": hotwords, "n_tokens": len(tokens)}
        )
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def _to_numpy(node):
    if isinstance(node, dict):
        return {k: _to_numpy(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_numpy(v) for v in node]
    return node.detach().cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description="write golden fixtures from the torch reference")
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda", help="where the mel runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(generate(args.out_dir, args.seed, device=args.device)))


if __name__ == "__main__":
    main()
