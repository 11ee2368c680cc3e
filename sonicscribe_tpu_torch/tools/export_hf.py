"""Export a native parameter tree to the HF checkpoint layout (the inverse
of tools/convert_weights.py:convert_hf_checkpoint).

The port's counterpart of the JAX package's ``tools/export_hf.py``, written
through ``tools/safetensors_io.py`` (no safetensors package). Two uses:

- interop: publish a converted model back into the HF layout;
- validation: a synthetic HF checkpoint (``model.safetensors`` with exactly
  the ``HF_NAME_MAP`` names and HF layouts, ``config.json`` and
  ``generation_config.json`` in the real checkpoint's nesting) drives the
  converter, the native loader and ``verify_checkpoint`` end to end where
  the real GLM-ASR-Nano weights are not at hand.

``make_test_tokenizer`` builds an HF fast tokenizer directory (byte-level
BPE trained in-process) whose special-token ids match GlmAsrConfig's
layout; it needs the ``tokenizers`` package, imported when called.
"""

from __future__ import annotations

import json
import os

import torch

from sonicscribe_tpu_torch.models.config import GlmAsrConfig
from sonicscribe_tpu_torch.tools import safetensors_io
from sonicscribe_tpu_torch.tools.convert_weights import (
    TRANSPOSED_SUFFIXES,
    _flatten,
    specialized_name_map,
)


def export_hf_checkpoint(
    params: dict,
    cfg: GlmAsrConfig,
    dst: str,
    name_map: dict[str, str] | None = None,
    dtype: torch.dtype = torch.float32,
) -> None:
    """Write `dst/model.safetensors` with HF names and layouts, every
    tensor in `dtype` (float32, as the JAX package writes, or bfloat16, as
    HF releases of this size store it), plus the config files.

    Inverse transforms of convert_hf_checkpoint: linear weights go back to
    HF's [out, in], convs back to [out, in, k], stacked layer tensors are
    unstacked per layer. `params` may live on any device.
    """
    flat = {k: torch.as_tensor(v).detach().to("cpu", dtype) for k, v in _flatten(params).items()}
    out: dict[str, torch.Tensor] = {}
    for ours, theirs in (name_map or specialized_name_map(cfg)).items():
        if "@{L}" in ours:
            base = ours.split("@")[0]
            stacked = flat[base]
            for layer in range(stacked.shape[0]):
                v = stacked[layer]
                if base.endswith(TRANSPOSED_SUFFIXES):
                    v = v.T
                out[theirs.replace("{L}", str(layer))] = v.contiguous()
        else:
            v = flat[ours]
            if ours.endswith(TRANSPOSED_SUFFIXES):
                v = v.T
            if ours.startswith("encoder/conv") and v.ndim == 3:
                v = v.permute(2, 1, 0)  # ours [k, in, out] -> HF conv1d [out, in, k]
            out[theirs] = v.contiguous()
    os.makedirs(dst, exist_ok=True)
    safetensors_io.save_file(out, os.path.join(dst, "model.safetensors"),
                             metadata={"format": "pt"})
    # the real GLM-ASR checkpoint's config layout (nested Whisper-style
    # audio_config + GLM-style text_config, special-token ids, and a
    # generation_config.json), so that every synthetic checkpoint exercises
    # convert_weights.cfg_from_hf_config
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(
            {
                "model_type": "glm-asr",
                "exported_by": "sonicscribe_tpu_torch",
                "audio_config": {
                    "num_mel_bins": cfg.encoder.n_mels,
                    "d_model": cfg.encoder.d_model,
                    "encoder_attention_heads": cfg.encoder.n_heads,
                    "encoder_layers": cfg.encoder.n_layers,
                    "encoder_ffn_dim": cfg.encoder.ffn_mult * cfg.encoder.d_model,
                    "max_source_positions": cfg.encoder.max_frames // 2,
                },
                "text_config": {
                    "vocab_size": cfg.decoder.vocab_size,
                    "hidden_size": cfg.decoder.d_model,
                    "num_hidden_layers": cfg.decoder.n_layers,
                    "num_attention_heads": cfg.decoder.n_heads,
                    "num_key_value_heads": cfg.decoder.n_kv_heads,
                    "head_dim": cfg.decoder.head_dim,
                    "intermediate_size": cfg.decoder.ffn_hidden,
                    "rope_theta": cfg.decoder.rope_theta,
                    "partial_rotary_factor": cfg.decoder.partial_rotary_factor,
                    "rms_norm_eps": cfg.decoder.rms_eps,
                    "attention_bias": cfg.decoder.qkv_bias,
                    "tie_word_embeddings": cfg.decoder.tie_embeddings,
                },
                "audio_start_token_id": cfg.audio_start_id,
                "audio_end_token_id": cfg.audio_end_id,
                "user_token_id": cfg.user_id,
                "assistant_token_id": cfg.assistant_id,
            },
            f,
            indent=2,
        )
    with open(os.path.join(dst, "generation_config.json"), "w") as f:
        json.dump({"eos_token_id": cfg.eos_id, "pad_token_id": cfg.pad_id,
                   "bos_token_id": cfg.bos_id, "do_sample": False}, f)


def make_test_tokenizer(dst: str, vocab_size: int, cfg: GlmAsrConfig) -> None:
    """Build an HF fast tokenizer directory: byte-level BPE trained
    in-process, with special tokens pinned to GlmAsrConfig's id layout
    (pad=0, bos=1, eos=2, ...). Loadable by AutoTokenizer without
    trust_remote_code."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    specials = ["<pad>", "<bos>", "<eos>", "<user>", "<assistant>",
                "<audio_start>", "<audio_end>"]
    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size,
        special_tokens=specials,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False,
    )
    corpus = [
        "please transcribe this audio into text",
        "pay special attention to these important terms",
        "the quick brown fox jumps over the lazy dog 0123456789",
    ]
    tok.train_from_iterator(corpus, trainer)
    os.makedirs(dst, exist_ok=True)
    tok.save(os.path.join(dst, "tokenizer.json"))
    with open(os.path.join(dst, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>",
                   "bos_token": "<bos>", "eos_token": "<eos>", "model_max_length": 1 << 20}, f)
    with open(os.path.join(dst, "special_tokens_map.json"), "w") as f:
        json.dump({"pad_token": "<pad>", "bos_token": "<bos>", "eos_token": "<eos>"}, f)
