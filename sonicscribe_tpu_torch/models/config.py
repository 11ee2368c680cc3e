"""Model architecture configuration for GLM-ASR-Nano-style audio LLMs.

The reference loads GLM-ASR-Nano-2512 via HF `trust_remote_code`
(reference: backend/asr.py:66-70,137), so the architecture is recovered from
the seams the reference exposes (SURVEY.md §2.4):

- chat-templated audio LLM: audio encoder -> `audio_proj` adapter ->
  decoder-only LM with tied embeddings (`lm_head`, `embed_tokens`,
  `audio_proj` named in the int8 skip-list, asr.py:176);
- Whisper-style log-mel front end (`processor.feature_extractor.sampling_rate`,
  asr.py:67);
- ~1.5-2.5B params at bf16 (VRAM table, SURVEY.md §6).

Everything is config-driven so a converted checkpoint's
`sonicscribe_config.json` (models/weights.py:load_checkpoint) rebuilds it;
tests and chip_smoke.py instantiate the `tiny()` / `nano()` presets.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class AudioEncoderConfig:
    """Whisper-style audio encoder: 2 convs (2x time subsampling), sinusoidal
    positions, pre-LN transformer stack with GELU MLPs."""

    n_mels: int = 128
    d_model: int = 1024
    n_heads: int = 16
    n_layers: int = 24
    ffn_mult: int = 4
    max_frames: int = 3000  # mel frames (30 s at 10 ms hop)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def max_positions(self) -> int:
        return self.max_frames // 2  # conv2 has stride 2


@dataclass(frozen=True)
class DecoderConfig:
    """GLM-style decoder-only LM: RMSNorm, partial RoPE, GQA with QKV bias,
    SwiGLU MLP, tied input/output embeddings."""

    vocab_size: int = 2048
    d_model: int = 2048
    n_layers: int = 28
    n_heads: int = 16
    n_kv_heads: int = 4
    head_dim: int = 128
    ffn_hidden: int = 5504
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 0.5
    rms_eps: float = 1e-5
    qkv_bias: bool = True
    tie_embeddings: bool = True
    # serving knob, not architecture: decode/verify programs quantize their
    # activations to int8 on the fly and use the native s8 MXU dot against
    # int8 weights (ops/quant.matmul_w8a8) instead of upcasting the weight
    # stream to bf16 on load. Decode-only — prefill keeps the W8A16 path.
    # Lives on the config because every decode program is jitted with cfg
    # static, so toggling it re-keys (and re-compiles) exactly the programs
    # whose numerics change. Set by quant mode "int8-decoder-a8".
    act_int8_decode: bool = False


@dataclass(frozen=True)
class GlmAsrConfig:
    encoder: AudioEncoderConfig = field(default_factory=AudioEncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    # adapter ("audio_proj"): stack `adapter_stack` consecutive encoder frames,
    # then 2-layer MLP into the LM embedding space
    adapter_stack: int = 4
    adapter_hidden: int = 4096
    # special token ids (byte-fallback tokenizer layout; converter overrides)
    pad_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    user_id: int = 3
    assistant_id: int = 4
    audio_start_id: int = 5
    audio_end_id: int = 6

    @property
    def frames_per_audio_token(self) -> int:
        return 2 * self.adapter_stack  # conv subsample x adapter stack

    def num_audio_tokens(self, mel_frames: int) -> int:
        return max(1, mel_frames // self.frames_per_audio_token)


def tiny(vocab_size: int = 384) -> GlmAsrConfig:
    """Small random-init config for tests and the multichip dryrun."""
    return GlmAsrConfig(
        encoder=AudioEncoderConfig(
            n_mels=128, d_model=64, n_heads=4, n_layers=2, max_frames=512
        ),
        decoder=DecoderConfig(
            vocab_size=vocab_size,
            d_model=128,
            n_layers=2,
            n_heads=4,
            n_kv_heads=2,
            head_dim=32,
            ffn_hidden=256,
        ),
        adapter_stack=4,
        adapter_hidden=128,
    )


def nano(vocab_size: int = 59520) -> GlmAsrConfig:
    """GLM-ASR-Nano-scale preset (~1.9B params total): the bench model.

    Sized to the reference's footprint evidence (bf16 ~4.9 GB incl. CUDA
    overhead, SURVEY.md §6): 24-layer d=1024 Whisper-style encoder (~0.3B) +
    28-layer d=2048 GQA decoder (~1.5B).
    """
    return GlmAsrConfig(
        encoder=AudioEncoderConfig(
            n_mels=128, d_model=1024, n_heads=16, n_layers=24, max_frames=3000
        ),
        decoder=DecoderConfig(
            vocab_size=vocab_size,
            d_model=2048,
            n_layers=28,
            n_heads=16,
            n_kv_heads=4,
            head_dim=128,
            ffn_hidden=5504,
        ),
        adapter_stack=4,
        adapter_hidden=4096,
    )


# =====================================================================
# Tensor parallelism: the rank-local shapes
# =====================================================================

# The Megatron blocks of the model: a column-parallel projection into the
# block, a row-parallel one out of it, whose partial sums are all-reduced
# (models/glm_asr.py's reduce sites, parallel/mesh.py's rules).
TP_BLOCKS = ("encoder_attn", "encoder_mlp", "adapter", "decoder_attn", "decoder_mlp")


@dataclass(frozen=True)
class RankEncoderConfig(AudioEncoderConfig):
    """A tensor-parallel rank's encoder: its share of the heads, and the
    whole model's head size (which d_model // n_heads would multiply by
    the tp degree)."""

    head_dim: int = 64


def tp_blocks(cfg: GlmAsrConfig, tp: int) -> frozenset:
    """The blocks a tp degree splits: those whose parallel axis divides by
    tp, in whole heads for attention (query and KV heads alike). A block
    that does not divide stays replicated whole, with no reduce: a
    Megatron pair cannot be half replicated."""
    enc, dec = cfg.encoder, cfg.decoder
    widths = {
        "encoder_attn": (enc.n_heads,),
        "encoder_mlp": (enc.d_model * enc.ffn_mult,),
        "adapter": (cfg.adapter_hidden,),
        "decoder_attn": (dec.n_heads, dec.n_kv_heads),
        "decoder_mlp": (dec.ffn_hidden,),
    }
    return frozenset(b for b in TP_BLOCKS if all(n % tp == 0 for n in widths[b]))


def tp_local(cfg: GlmAsrConfig, tp: int) -> GlmAsrConfig:
    """The config of one rank of a tp-way split (tp_blocks): the heads, KV
    heads, decoder ffn_hidden and adapter_hidden of each split block
    divided by tp; a replicated block keeps its whole widths. The encoder
    keeps the whole model's head size; its MLP's width is its weights'
    (ffn_mult stays the model's). W8A8 decode (act_int8_decode) carries
    over: at each row-parallel product the rank's row scale comes from the
    max of |x| over every rank's share (models/glm_asr.py), so its xq is
    the matching slice of the whole row's."""
    if tp == 1:
        return cfg
    split = tp_blocks(cfg, tp)
    enc, dec = cfg.encoder, cfg.decoder
    enc_heads = enc.n_heads // tp if "encoder_attn" in split else enc.n_heads
    encoder = RankEncoderConfig(**{f: getattr(enc, f) for f in
                                   ("n_mels", "d_model", "n_layers", "ffn_mult", "max_frames")},
                                n_heads=enc_heads, head_dim=enc.head_dim)
    if "decoder_attn" in split:
        dec = replace(dec, n_heads=dec.n_heads // tp, n_kv_heads=dec.n_kv_heads // tp)
    if "decoder_mlp" in split:
        dec = replace(dec, ffn_hidden=dec.ffn_hidden // tp)
    hidden = cfg.adapter_hidden // tp if "adapter" in split else cfg.adapter_hidden
    return replace(cfg, encoder=encoder, decoder=dec, adapter_hidden=hidden)
