"""HF -> native checkpoint conversion, without JAX.

The port's counterpart of the JAX package's ``tools/convert_weights.py``:
the same name map, shape table, config derivation and native layout, so
that a checkpoint either package writes loads in both.

- native format: ``<dir>/sonicscribe_config.json`` + ``<dir>/params.npz``
  (flat /-joined keys, bf16 leaves stored as uint16 views with a
  ``dtypes`` table), read by ``models/weights.py:load_checkpoint``.
- conversion: ``convert_hf_checkpoint(src, dst)`` reads an HF GLM-ASR
  directory (safetensors through ``tools/safetensors_io.py``, F32, F16 or
  BF16; torch ``.bin`` files through ``torch.load``) and maps weights
  through ``HF_NAME_MAP``. The mapping table is data: when the real
  checkpoint's module names differ, extend the table, not the model.

    python -m sonicscribe_tpu_torch.tools.convert_weights <hf_dir> <out_dir> [--int8]
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Callable

import numpy as np
import torch

from sonicscribe_tpu_torch.models.config import (
    AudioEncoderConfig,
    DecoderConfig,
    GlmAsrConfig,
)
from sonicscribe_tpu_torch.models.weights import NATIVE_CONFIG, NATIVE_PARAMS, _unflatten
from sonicscribe_tpu_torch.ops.quant import quantize_params_int8
from sonicscribe_tpu_torch.tools import safetensors_io

# ---------------------------------------------------------------------
# native npz checkpoint
# ---------------------------------------------------------------------


def _flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dicts and lists -> {"a/b/0/c": leaf}, the native keys."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        elif isinstance(v, list):
            for i, item in enumerate(v):
                out.update(_flatten(item, f"{key}/{i}"))
        else:
            out[key] = v
    return out


def _to_numpy(v) -> tuple[np.ndarray, str]:
    """A leaf -> (the array stored, its dtype tag): bf16 has no numpy
    dtype and is stored as its uint16 bits, tagged "bfloat16"."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        v = t.numpy()
    v = np.asarray(v)
    return v, v.dtype.name


def save_checkpoint(params: dict, cfg: GlmAsrConfig, path: str) -> None:
    """A parameter tree (tensors on any device, or arrays) -> the native
    npz directory, the JAX package's save_checkpoint layout."""
    os.makedirs(path, exist_ok=True)
    store, dtypes = {}, {}
    for k, v in _flatten(params).items():
        store[k], dtypes[k] = _to_numpy(v)
    np.savez(os.path.join(path, NATIVE_PARAMS), **store)
    with open(os.path.join(path, NATIVE_CONFIG), "w") as f:
        json.dump(
            {"model_config": dataclasses.asdict(cfg), "dtypes": dtypes, "format_version": 1},
            f,
            indent=2,
        )


# ---------------------------------------------------------------------
# HF -> native conversion
# ---------------------------------------------------------------------

# Maps our parameter-tree path (template) to an HF state-dict name (template).
# {L} expands per decoder/encoder layer; weights needing transpose are listed
# in TRANSPOSED_SUFFIXES (HF Linear stores [out, in]; we store [in, out]).
HF_NAME_MAP: dict[str, str] = {
    "encoder/conv1/w": "audio_encoder.conv1.weight",
    "encoder/conv1/b": "audio_encoder.conv1.bias",
    "encoder/conv2/w": "audio_encoder.conv2.weight",
    "encoder/conv2/b": "audio_encoder.conv2.bias",
    "encoder/layers/ln1_scale@{L}": "audio_encoder.layers.{L}.self_attn_layer_norm.weight",
    "encoder/layers/ln1_bias@{L}": "audio_encoder.layers.{L}.self_attn_layer_norm.bias",
    "encoder/layers/q_w@{L}": "audio_encoder.layers.{L}.self_attn.q_proj.weight",
    "encoder/layers/q_b@{L}": "audio_encoder.layers.{L}.self_attn.q_proj.bias",
    "encoder/layers/k_w@{L}": "audio_encoder.layers.{L}.self_attn.k_proj.weight",
    "encoder/layers/v_w@{L}": "audio_encoder.layers.{L}.self_attn.v_proj.weight",
    "encoder/layers/v_b@{L}": "audio_encoder.layers.{L}.self_attn.v_proj.bias",
    "encoder/layers/o_w@{L}": "audio_encoder.layers.{L}.self_attn.out_proj.weight",
    "encoder/layers/o_b@{L}": "audio_encoder.layers.{L}.self_attn.out_proj.bias",
    "encoder/layers/ln2_scale@{L}": "audio_encoder.layers.{L}.final_layer_norm.weight",
    "encoder/layers/ln2_bias@{L}": "audio_encoder.layers.{L}.final_layer_norm.bias",
    "encoder/layers/fc1_w@{L}": "audio_encoder.layers.{L}.fc1.weight",
    "encoder/layers/fc1_b@{L}": "audio_encoder.layers.{L}.fc1.bias",
    "encoder/layers/fc2_w@{L}": "audio_encoder.layers.{L}.fc2.weight",
    "encoder/layers/fc2_b@{L}": "audio_encoder.layers.{L}.fc2.bias",
    "encoder/ln_post_scale": "audio_encoder.layer_norm.weight",
    "encoder/ln_post_bias": "audio_encoder.layer_norm.bias",
    "adapter/fc1/w": "audio_proj.linear_1.weight",
    "adapter/fc1/b": "audio_proj.linear_1.bias",
    "adapter/fc2/w": "audio_proj.linear_2.weight",
    "adapter/fc2/b": "audio_proj.linear_2.bias",
    "decoder/embed": "model.embed_tokens.weight",
    "decoder/layers/ln1_scale@{L}": "model.layers.{L}.input_layernorm.weight",
    "decoder/layers/qkv_w@{L}": "model.layers.{L}.self_attn.qkv_proj.weight",
    "decoder/layers/qkv_b@{L}": "model.layers.{L}.self_attn.qkv_proj.bias",
    "decoder/layers/o_w@{L}": "model.layers.{L}.self_attn.o_proj.weight",
    "decoder/layers/ln2_scale@{L}": "model.layers.{L}.post_attention_layernorm.weight",
    "decoder/layers/gate_up_w@{L}": "model.layers.{L}.mlp.gate_up_proj.weight",
    "decoder/layers/down_w@{L}": "model.layers.{L}.mlp.down_proj.weight",
    "decoder/ln_f_scale": "model.norm.weight",
}

TRANSPOSED_SUFFIXES = (
    "q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w",
    "qkv_w", "gate_up_w", "down_w", "fc1/w", "fc2/w", "lm_head",
)

# HF tensors that are EXPECTED to have no native mapping: derived buffers
# (rotary tables, position ids), Whisper-style stored sinusoids (computed
# here), and lm_head when embeddings are tied. Anything else unconsumed is
# reported loudly by convert_hf_checkpoint.
IGNORABLE_HF_PATTERNS = (
    ".rotary_emb.", ".inv_freq", "position_ids", "embed_positions",
    "masked_spec_embed",
)

TOKENIZER_FILES = (
    "tokenizer.json", "tokenizer_config.json", "special_tokens_map.json",
    "vocab.json", "merges.txt", "tokenizer.model",
)


def specialized_name_map(cfg: GlmAsrConfig) -> dict[str, str]:
    """HF_NAME_MAP for this architecture: a no-bias checkpoint
    (attention_bias=false) has no qkv_proj.bias tensors, and an untied one
    (tie_word_embeddings=false) carries a real lm_head."""
    name_map = dict(HF_NAME_MAP)
    if not cfg.decoder.qkv_bias:
        name_map.pop("decoder/layers/qkv_b@{L}")
    if not cfg.decoder.tie_embeddings:
        name_map["decoder/lm_head"] = "lm_head.weight"
    return name_map


def expected_shapes(cfg: GlmAsrConfig) -> dict[str, tuple[int, ...]]:
    """Flat native-key -> shape table (models/weights.init_random's shapes,
    without materializing weights), so that the converter validates every
    mapped tensor's shape and breaks loudly on a layout or name-mapping
    mistake."""
    enc, dec = cfg.encoder, cfg.decoder
    d, dd = enc.d_model, dec.d_model
    qkv_out = (dec.n_heads + 2 * dec.n_kv_heads) * dec.head_dim
    shapes: dict[str, tuple[int, ...]] = {
        "encoder/conv1/w": (3, enc.n_mels, d),
        "encoder/conv1/b": (d,),
        "encoder/conv2/w": (3, d, d),
        "encoder/conv2/b": (d,),
        "encoder/layers/ln1_scale": (enc.n_layers, d),
        "encoder/layers/ln1_bias": (enc.n_layers, d),
        "encoder/layers/q_w": (enc.n_layers, d, d),
        "encoder/layers/q_b": (enc.n_layers, d),
        "encoder/layers/k_w": (enc.n_layers, d, d),
        "encoder/layers/v_w": (enc.n_layers, d, d),
        "encoder/layers/v_b": (enc.n_layers, d),
        "encoder/layers/o_w": (enc.n_layers, d, d),
        "encoder/layers/o_b": (enc.n_layers, d),
        "encoder/layers/ln2_scale": (enc.n_layers, d),
        "encoder/layers/ln2_bias": (enc.n_layers, d),
        "encoder/layers/fc1_w": (enc.n_layers, d, enc.ffn_mult * d),
        "encoder/layers/fc1_b": (enc.n_layers, enc.ffn_mult * d),
        "encoder/layers/fc2_w": (enc.n_layers, enc.ffn_mult * d, d),
        "encoder/layers/fc2_b": (enc.n_layers, d),
        "encoder/ln_post_scale": (d,),
        "encoder/ln_post_bias": (d,),
        "adapter/fc1/w": (cfg.adapter_stack * d, cfg.adapter_hidden),
        "adapter/fc1/b": (cfg.adapter_hidden,),
        "adapter/fc2/w": (cfg.adapter_hidden, dd),
        "adapter/fc2/b": (dd,),
        "decoder/embed": (dec.vocab_size, dd),
        "decoder/layers/ln1_scale": (dec.n_layers, dd),
        "decoder/layers/qkv_w": (dec.n_layers, dd, qkv_out),
        "decoder/layers/qkv_b": (dec.n_layers, qkv_out),
        "decoder/layers/o_w": (dec.n_layers, dec.n_heads * dec.head_dim, dd),
        "decoder/layers/ln2_scale": (dec.n_layers, dd),
        "decoder/layers/gate_up_w": (dec.n_layers, dd, 2 * dec.ffn_hidden),
        "decoder/layers/down_w": (dec.n_layers, dec.ffn_hidden, dd),
        "decoder/ln_f_scale": (dd,),
    }
    if not dec.tie_embeddings:
        shapes["decoder/lm_head"] = (dd, dec.vocab_size)
    return shapes


def _first(d: dict, *keys, default=None):
    for k in keys:
        if k in d and d[k] is not None:
            return d[k]
    return default


def cfg_from_hf_config(src: str) -> GlmAsrConfig:
    """Derive GlmAsrConfig from an HF checkpoint directory's config.json
    (+ generation_config.json special-token ids, + weight shapes for the
    adapter dims): nested `audio_config` / `text_config` (Whisper-style
    encoder keys, GLM-style decoder keys), with flat-key fallbacks. Raises
    with the full missing-field list: a conversion against the real
    checkpoint fails loudly, it never guesses."""
    cfg_path = os.path.join(src, "config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(
            f"no config.json in '{src}' — pass an explicit GlmAsrConfig "
            f"(--preset) or point at a complete HF checkpoint dir"
        )
    with open(cfg_path) as f:
        hf = json.load(f)
    audio = hf.get("audio_config") or hf.get("audio_encoder_config") or hf
    text = hf.get("text_config") or hf.get("llm_config") or hf

    missing: list[str] = []

    def need(d: dict, *keys, scope: str):
        v = _first(d, *keys)
        if v is None:
            missing.append(f"{scope}: one of {keys}")
        return v

    enc_kw = dict(
        n_mels=need(audio, "num_mel_bins", "n_mels", scope="audio"),
        d_model=need(audio, "d_model", "hidden_size", scope="audio"),
        n_heads=need(audio, "encoder_attention_heads", "num_attention_heads",
                     "n_heads", scope="audio"),
        n_layers=need(audio, "encoder_layers", "num_hidden_layers",
                      "n_layers", scope="audio"),
    )
    max_src = _first(audio, "max_source_positions")
    dec_kw = dict(
        vocab_size=need(text, "vocab_size", scope="text"),
        d_model=need(text, "hidden_size", "d_model", scope="text"),
        n_layers=need(text, "num_hidden_layers", "n_layers", scope="text"),
        n_heads=need(text, "num_attention_heads", "n_heads", scope="text"),
        n_kv_heads=need(text, "num_key_value_heads", "n_kv_heads", scope="text"),
        head_dim=_first(text, "head_dim"),
        ffn_hidden=need(text, "intermediate_size", "ffn_hidden", scope="text"),
    )
    if missing:
        raise ValueError(
            "config.json is missing required architecture fields:\n  - "
            + "\n  - ".join(missing)
            + f"\n(top-level keys present: {sorted(hf)[:20]})"
        )
    if dec_kw["head_dim"] is None:
        dec_kw["head_dim"] = dec_kw["d_model"] // dec_kw["n_heads"]
    if max_src is not None:
        # HF Whisper stores post-conv positions; our max_frames is pre-conv
        enc_kw["max_frames"] = int(max_src) * 2
    ffn_mult = _first(audio, "encoder_ffn_dim")
    if ffn_mult is not None:
        enc_kw["ffn_mult"] = int(ffn_mult) // int(enc_kw["d_model"])

    dec = DecoderConfig(
        **{k: int(v) for k, v in dec_kw.items()},
        rope_theta=float(_first(text, "rope_theta", default=10000.0)),
        partial_rotary_factor=float(_first(text, "partial_rotary_factor", default=0.5)),
        rms_eps=float(_first(text, "rms_norm_eps", default=1e-5)),
        qkv_bias=bool(_first(text, "attention_bias", "qkv_bias", default=True)),
        tie_embeddings=bool(
            _first(text, "tie_word_embeddings", default=hf.get("tie_word_embeddings", True))
        ),
    )
    enc = AudioEncoderConfig(**{k: int(v) for k, v in enc_kw.items()})

    # adapter dims are not in config.json conventions: read them off the
    # audio_proj weights themselves (shape [hidden, stack*d] in HF layout)
    adapter_stack, adapter_hidden = 4, 4096
    try:
        w = _peek_hf_shapes(src, ("audio_proj.linear_1.weight",)).get("audio_proj.linear_1.weight")
        if w is None:
            # weights ARE present but the adapter tensor isn't: naming drift
            # in the real checkpoint; never default silently
            raise ValueError(
                "weights present but 'audio_proj.linear_1.weight' not found — "
                "adapter naming drift vs the reference's audio_proj module; "
                "extend HF_NAME_MAP/cfg_from_hf_config"
            )
        adapter_hidden = int(w[0])
        if int(w[1]) % enc.d_model:
            raise ValueError(
                f"audio_proj.linear_1.weight in-dim {w[1]} is not a multiple of "
                f"encoder d_model {enc.d_model} — the adapter is not frame-stacking; "
                f"extend the model"
            )
        adapter_stack = int(w[1]) // enc.d_model
    except FileNotFoundError:
        pass  # config-only derivation (no weights present)

    specials: dict[str, int] = {}
    gen_path = os.path.join(src, "generation_config.json")
    if os.path.exists(gen_path):
        with open(gen_path) as f:
            gen = json.load(f)
        for ours, theirs in (("eos_id", "eos_token_id"), ("pad_id", "pad_token_id"),
                             ("bos_id", "bos_token_id")):
            v = gen.get(theirs)
            if isinstance(v, list):
                v = v[0]
            if v is not None:
                specials[ours] = int(v)
    for ours, theirs in (
        ("audio_start_id", "audio_start_token_id"),
        ("audio_end_id", "audio_end_token_id"),
        ("user_id", "user_token_id"),
        ("assistant_id", "assistant_token_id"),
        ("eos_id", "eos_token_id"),
        ("pad_id", "pad_token_id"),
        ("bos_id", "bos_token_id"),
    ):
        v = hf.get(theirs)
        if v is not None and ours not in specials:
            specials[ours] = int(v)

    return GlmAsrConfig(encoder=enc, decoder=dec, adapter_stack=adapter_stack,
                        adapter_hidden=adapter_hidden, **specials)


def _weight_files(src: str) -> tuple[list[str], list[str]]:
    """(safetensors files, torch .bin files) of a checkpoint directory."""
    names = sorted(os.listdir(src))
    return ([os.path.join(src, f) for f in names if f.endswith(".safetensors")],
            [os.path.join(src, f) for f in names if f.endswith(".bin")])


def _peek_hf_shapes(src: str, names: tuple[str, ...]) -> dict[str, tuple[int, ...]]:
    """Just the shapes of `names` from the checkpoint's weight files (the
    safetensors header only, no tensor data)."""
    st_files, bin_files = _weight_files(src)
    out: dict[str, tuple[int, ...]] = {}
    for path in st_files:
        shapes = safetensors_io.read_shapes(path)
        out.update({n: shapes[n] for n in names if n in shapes})
    for path in [] if st_files else bin_files:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        out.update({n: tuple(sd[n].shape) for n in names if n in sd})
    if not st_files and not bin_files:
        raise FileNotFoundError(f"no safetensors/bin weights in '{src}'")
    return out


def _load_hf_state_dict(src: str) -> dict[str, torch.Tensor]:
    """All tensors of an HF checkpoint dir (safetensors, else torch .bin) as
    CPU tensors in their stored dtypes, BF16 included."""
    st_files, bin_files = _weight_files(src)
    tensors: dict[str, torch.Tensor] = {}
    for path in st_files:
        tensors.update(safetensors_io.load_file(path))
    for path in [] if st_files else bin_files:
        tensors.update(torch.load(path, map_location="cpu", weights_only=True))
    if not st_files and not bin_files:
        raise FileNotFoundError(f"no safetensors/bin weights in '{src}'")
    return tensors


def _cfg_diff(given: GlmAsrConfig, derived: GlmAsrConfig) -> list[str]:
    diffs = []
    for scope, a, b in (("encoder", given.encoder, derived.encoder),
                        ("decoder", given.decoder, derived.decoder)):
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if va != vb:
                diffs.append(f"{scope}.{f.name}: given={va} config.json={vb}")
    for f in ("adapter_stack", "adapter_hidden", "pad_id", "bos_id", "eos_id",
              "audio_start_id", "audio_end_id", "user_id", "assistant_id"):
        va, vb = getattr(given, f), getattr(derived, f)
        if va != vb:
            diffs.append(f"{f}: given={va} config.json={vb}")
    return diffs


def convert_hf_checkpoint(
    src: str,
    dst: str,
    cfg: GlmAsrConfig | None = None,
    name_map: dict[str, str] | None = None,
    int8: bool = False,
    progress: Callable[[str], None] = print,
) -> GlmAsrConfig:
    """Convert an HF GLM-ASR checkpoint into the native format.

    With cfg=None the architecture is derived from the checkpoint's own
    config.json (`cfg_from_hf_config`); an explicit cfg is cross-checked
    against config.json where there is one. Every mapped tensor's shape is
    checked against the model's expected-shape table, and HF tensors the
    map never consumed are reported: name-mapping drift against the real
    checkpoint breaks loudly. Leaves are cast to bf16 (round to nearest
    even); with int8 the projections are then quantized on the CPU
    (ops/quant.py)."""
    derived: GlmAsrConfig | None = None
    if os.path.exists(os.path.join(src, "config.json")):
        try:
            derived = cfg_from_hf_config(src)
        except (ValueError, FileNotFoundError) as e:
            if cfg is None:
                raise
            progress(f"note: config.json not derivable ({e}); using given cfg")
    if cfg is None:
        if derived is None:
            raise FileNotFoundError(f"no derivable config.json in '{src}' and no explicit cfg")
        cfg = derived
    elif derived is not None and derived != cfg:
        raise ValueError("explicit cfg disagrees with the checkpoint's config.json:\n  - "
                         + "\n  - ".join(_cfg_diff(cfg, derived)))

    sd = _load_hf_state_dict(src)
    if name_map is None:
        name_map = specialized_name_map(cfg)
    flat: dict[str, torch.Tensor] = {}
    consumed: set[str] = set()

    def fetch(hf_name: str) -> torch.Tensor:
        if hf_name not in sd:
            raise KeyError(f"HF tensor '{hf_name}' not found; adjust HF_NAME_MAP "
                           f"(available sample: {list(sd)[:8]})")
        consumed.add(hf_name)
        return sd[hf_name]

    for ours, theirs in name_map.items():
        if "@{L}" in ours:
            base = ours.split("@")[0]
            n_layers = cfg.encoder.n_layers if base.startswith("encoder") else cfg.decoder.n_layers
            stack = []
            for layer in range(n_layers):
                v = fetch(theirs.replace("{L}", str(layer)))
                stack.append(v.T if base.endswith(TRANSPOSED_SUFFIXES) else v)
            flat[base] = torch.stack(stack)
        else:
            v = fetch(theirs)
            if ours.endswith(TRANSPOSED_SUFFIXES):
                v = v.T
            if ours.startswith("encoder/conv") and v.ndim == 3:
                v = v.permute(2, 1, 0)  # HF conv1d [out, in, k] -> [k, in, out]
            flat[ours] = v

    if "decoder/layers/qkv_b" not in flat:
        # no-bias checkpoint: the forward skips the add (cfg.qkv_bias is
        # False) but the tree always carries the leaf: zeros
        dec = cfg.decoder
        qkv_out = (dec.n_heads + 2 * dec.n_kv_heads) * dec.head_dim
        flat["decoder/layers/qkv_b"] = torch.zeros((dec.n_layers, qkv_out))

    # every mapped tensor's shape against the model's table, all mismatches
    # in one report
    want = expected_shapes(cfg)
    shape_errors = [
        f"{k}: converted {tuple(flat[k].shape)} != expected {want[k]}"
        for k in flat if k in want and tuple(flat[k].shape) != want[k]
    ]
    shape_errors += [f"{k}: missing from conversion" for k in want if k not in flat]
    # a converted leaf the model does not expect (a typoed custom name_map
    # entry) would otherwise pass unchecked as an extra leaf
    shape_errors += [f"{k}: converted but not expected by the model (typoed name_map entry?)"
                     for k in flat if k not in want]
    if shape_errors:
        raise ValueError(
            "converted tensors do not match the model's expected shapes "
            "(name-mapping or layout drift vs the real checkpoint):\n  - "
            + "\n  - ".join(shape_errors)
        )
    leftovers = [
        n for n in sd
        if n not in consumed
        and not any(p in n for p in IGNORABLE_HF_PATTERNS)
        and not (cfg.decoder.tie_embeddings and n == "lm_head.weight")
    ]
    if leftovers:
        progress(
            f"WARNING: {len(leftovers)} HF tensors were NOT consumed by HF_NAME_MAP "
            f"(first 12): {leftovers[:12]} — extend the map if these carry weights "
            f"the model needs"
        )

    params = _unflatten({k: v.to(torch.bfloat16).contiguous() for k, v in flat.items()})
    if int8:
        params = quantize_params_int8(params)
    save_checkpoint(params, cfg, dst)

    # carry the HF tokenizer along so that load_checkpoint serves HFTokenizer
    tok_files = [f for f in TOKENIZER_FILES if os.path.exists(os.path.join(src, f))]
    if tok_files:
        tok_dst = os.path.join(dst, "tokenizer")
        os.makedirs(tok_dst, exist_ok=True)
        for f in tok_files:
            shutil.copy2(os.path.join(src, f), os.path.join(tok_dst, f))
    progress(f"converted {len(flat)} tensors -> {dst}"
             + (f" (+ tokenizer: {len(tok_files)} files)" if tok_files else ""))
    return cfg


def main(argv=None):
    import argparse

    from sonicscribe_tpu_torch.models.config import nano, tiny

    ap = argparse.ArgumentParser(description="Convert an HF GLM-ASR checkpoint to the "
                                             "native npz format")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument(
        "--preset", choices=("derive", "nano", "tiny"), default="derive",
        help="'derive' (default) reads the architecture from the checkpoint's "
             "config.json and fails loudly if it can't; nano/tiny force a preset "
             "(cross-checked against config.json)",
    )
    args = ap.parse_args(argv)
    cfg = {"derive": None, "nano": nano(), "tiny": tiny()}[args.preset]
    convert_hf_checkpoint(args.src, args.dst, cfg, int8=args.int8)


if __name__ == "__main__":
    main()
