"""GLM-ASR-Nano audio LLM in PyTorch: port of the JAX package's
``models/glm_asr.py``.

Plain functions on a parameter tree of tensors with the JAX package's
layout (stacked layers on a leading axis, conv weights [K, C_in, C_out],
KV cache [L, B, M, nkv, hd]), so the same tree and the same inputs can be
held against the JAX functions:

- a Whisper-style audio encoder (2 convs with 2x time subsampling,
  sinusoidal positions, pre-LN transformer, exact GELU),
- the `audio_proj` adapter (frame stacking + 2-layer MLP),
- a GLM-style decoder-only LM (RMSNorm, partial NeoX RoPE with float32
  angles, GQA with QKV bias, SwiGLU, tied embeddings), float32 logits,
- an explicit KV cache with `prefill` / `decode_step`, and `verify_step`
  (W1 query positions per slot in one pass: speculative verification).

Decode and verify attention go through ``ops.decode_attention`` (the CUDA
kernel on the card). Encoder and prefill attention are written as the JAX package
writes them: einsum, float32 softmax, additive NEG_INF masks.

Every quantizable projection goes through ``ops.quant``: a plain weight is
``x @ w``; an int8 QTensor takes the flat W8A16 kernel in the encoder and
in prefill, and the stacked one (or W8A8 when ``act_int8_decode`` is set)
in the decode step, which hands the kernel the whole stack and a layer
index.

Unlike JAX, the port updates the KV cache IN PLACE: `prefill`,
`decode_step` and `verify_step` write into the cache tensors they are given, its length
included, so a CUDA graph of the decode step reads and writes the same
cache on every replay (engine/exec_store.py).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sonicscribe_tpu_torch.models.config import DecoderConfig, GlmAsrConfig
from sonicscribe_tpu_torch.ops.decode_attention import decode_attention, verify_attention
from sonicscribe_tpu_torch.ops.quant import is_qtensor, matmul, matmul_w8a8

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

NEG_INF = -1e30


def param_count(params: Params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    return sum(param_count(v) for v in params.values())


# =====================================================================
# Shared primitives
# =====================================================================


def _layer_norm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)  # population variance
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def _rms_norm(x, scale, eps):
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (out * scale.float()).to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="none")


def _mm_f32(x, w):
    """x [..., K] @ w [K, N] with a float32 result that is not rounded to
    x's dtype first (JAX's preferred_element_type=float32)."""
    if x.dtype == torch.float32 or x.device.type == "cpu":
        return x.float() @ w.float()
    lead = x.shape[:-1]
    out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return out.reshape(*lead, w.shape[-1])


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper-style fixed sinusoidal positions [length, channels]."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    ang = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _sinusoid_table(length: int, channels: int, device: torch.device, dtype) -> torch.Tensor:
    """_sinusoids on `device` in `dtype`, built once: a host-to-device copy
    cannot run inside a CUDA graph capture, so encode_audio reads this."""
    return torch.from_numpy(_sinusoids(length, channels)).to(device, dtype)


def _rope_tables(cfg: DecoderConfig, positions: torch.Tensor):
    """cos/sin tables for positions; rotary over the first
    `head_dim * partial_rotary_factor` dims, NeoX half-split convention."""
    rot = int(cfg.head_dim * cfg.partial_rotary_factor)
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=positions.device) / rot
    inv_freq = 1.0 / (cfg.rope_theta ** exps)
    ang = positions.float()[..., None] * inv_freq  # [..., rot//2]
    return torch.cos(ang), torch.sin(ang), rot


def _apply_rope(x, cos, sin, rot):
    """x: [..., H, head_dim]; cos/sin: [..., rot//2] broadcast over heads."""
    x1 = x[..., : rot // 2].float()
    x2 = x[..., rot // 2 : rot].float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    out1 = x1 * c - x2 * s
    out2 = x2 * c + x1 * s
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), x[..., rot:]], dim=-1)


def _layer(stacked: Params, i: int, whole_qtensors: bool = False) -> Params:
    """Layer i of a stacked tree. A QTensor becomes its layer's views
    (encoder, prefill: the flat kernel), or with `whole_qtensors` stays the
    whole stack tagged with its layer (decode step: the stacked kernel)."""
    out = {}
    for k, v in stacked.items():
        if not is_qtensor(v):
            out[k] = v[i]
        elif whole_qtensors:
            out[k] = dict(v, layer=i)
        else:
            out[k] = {"q": v["q"][i], "scale": v["scale"][i]}
    return out


# =====================================================================
# Audio encoder + adapter
# =====================================================================


def _conv1d(x, w, b, stride: int):
    """x: [B, T, C_in], w: [K, C_in, C_out] -> [B, T', C_out], padding 1."""
    out = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), stride=stride, padding=1)
    return (out.transpose(1, 2).float() + b.float()).to(x.dtype)


def _encoder_block(x, mask_bias, lp, n_heads: int):
    """One pre-LN transformer block. x: [B, S, D]; mask_bias: [B, 1, 1, S]."""
    B, S, D = x.shape
    hd = D // n_heads

    h = _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
    q = (matmul(h, lp["q_w"]) + lp["q_b"]).reshape(B, S, n_heads, hd)
    k = matmul(h, lp["k_w"]).reshape(B, S, n_heads, hd)
    v = (matmul(h, lp["v_w"]) + lp["v_b"]).reshape(B, S, n_heads, hd)

    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(hd)) + mask_bias
    attn = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, S, D)
    x = x + matmul(ctx, lp["o_w"]) + lp["o_b"]

    h = _layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
    h = _gelu(matmul(h, lp["fc1_w"]) + lp["fc1_b"])
    return x + matmul(h, lp["fc2_w"]) + lp["fc2_b"]


def encode_audio(
    params: Params,
    cfg: GlmAsrConfig,
    mel: torch.Tensor,  # [B, T, n_mels], zero-padded
    n_frames: torch.Tensor,  # [B] true frame counts
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (audio_embeds [B, T // frames_per_audio_token, d_lm], n_tokens [B])."""
    enc = cfg.encoder
    p = params["encoder"]
    B = mel.shape[0]

    x = _gelu(_conv1d(mel, p["conv1"]["w"], p["conv1"]["b"], 1))
    x = _gelu(_conv1d(x, p["conv2"]["w"], p["conv2"]["b"], 2))
    S = x.shape[1]  # T // 2

    x = x + _sinusoid_table(S, enc.d_model, x.device, x.dtype)[None]

    # padding mask over subsampled frames
    n_frames = n_frames.to(x.device)
    valid = torch.arange(S, device=x.device)[None, :] < torch.ceil(n_frames / 2).long()[:, None]
    mask_bias = torch.where(valid, 0.0, NEG_INF).float()[:, None, None, :]

    for i in range(enc.n_layers):
        x = _encoder_block(x, mask_bias, _layer(p["layers"], i), enc.n_heads)
    x = _layer_norm(x, p["ln_post_scale"], p["ln_post_bias"])
    x = torch.where(valid[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))

    # adapter ("audio_proj"): stack k frames -> MLP -> LM space
    k = cfg.adapter_stack
    S_out = S // k
    x = x[:, : S_out * k].reshape(B, S_out, k * enc.d_model)
    a = params["adapter"]
    x = _gelu(x @ a["fc1"]["w"] + a["fc1"]["b"])
    x = x @ a["fc2"]["w"] + a["fc2"]["b"]

    n_tokens = torch.clamp(n_frames // cfg.frames_per_audio_token, min=1)
    return x, n_tokens.to(torch.int32)


# =====================================================================
# Decoder: KV cache, prefill, decode step
# =====================================================================


def init_cache(
    cfg: GlmAsrConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None
) -> Cache:
    dec = cfg.decoder
    shape = (dec.n_layers, batch, max_len, dec.n_kv_heads, dec.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    embed = params["decoder"]["embed"]
    return embed[tokens.to(embed.device, torch.long)]


def _decoder_qkv(lp, h, dec: DecoderConfig, mm=matmul):
    lead = h.shape[:-1]
    qkv = mm(h, lp["qkv_w"])
    if dec.qkv_bias:
        qkv = qkv + lp["qkv_b"]
    nq = dec.n_heads * dec.head_dim
    nkv = dec.n_kv_heads * dec.head_dim
    q = qkv[..., :nq].reshape(*lead, dec.n_heads, dec.head_dim)
    k = qkv[..., nq : nq + nkv].reshape(*lead, dec.n_kv_heads, dec.head_dim)
    v = qkv[..., nq + nkv :].reshape(*lead, dec.n_kv_heads, dec.head_dim)
    return q, k, v


def _decoder_layer_mlp(h, lp, dec: DecoderConfig, mm=matmul):
    """Post-attention half of every decoder layer."""
    hn = _rms_norm(h, lp["ln2_scale"], dec.rms_eps)
    gate, up = torch.chunk(mm(hn, lp["gate_up_w"]), 2, dim=-1)
    return h + mm(F.silu(gate) * up, lp["down_w"])


def _decoder_layer_prefill(x, lp, dec: DecoderConfig, cos, sin, rot, mask_bias):
    """x: [B, S, D]; returns (x', (k_layer, v_layer)) for cache storage."""
    B, S, _ = x.shape
    nkv, g = dec.n_kv_heads, dec.n_heads // dec.n_kv_heads
    h = _rms_norm(x, lp["ln1_scale"], dec.rms_eps)
    q, k, v = _decoder_qkv(lp, h, dec)
    q = _apply_rope(q, cos, sin, rot)
    k = _apply_rope(k, cos, sin, rot)

    qg = q.reshape(B, S, nkv, g, dec.head_dim)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = scores * (1.0 / math.sqrt(dec.head_dim)) + mask_bias
    attn = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bkgqs,bskd->bqkgd", attn, v).reshape(B, S, dec.n_heads * dec.head_dim)
    x = x + matmul(ctx, lp["o_w"])
    return _decoder_layer_mlp(x, lp, dec), (k, v)


def _lm_logits(params: Params, cfg: GlmAsrConfig, h: torch.Tensor) -> torch.Tensor:
    dec = cfg.decoder
    h = _rms_norm(h, params["decoder"]["ln_f_scale"], dec.rms_eps)
    if dec.tie_embeddings:
        w = params["decoder"]["embed"].T
    else:
        w = params["decoder"]["lm_head"]
    return _mm_f32(h, w)


def prefill_kv(
    params: Params,
    cfg: GlmAsrConfig,
    embeds: torch.Tensor,  # [B, S, D] zero-padded prompt embeddings
    length: torch.Tensor,  # [B] true prompt lengths
):
    """Run the prompt through the decoder without a cache object.

    Returns (ks, vs, last_logits): ks/vs are [L, B, S, nkv, hd];
    last_logits [B, V] float32 is taken at each row's final real position.
    """
    dec = cfg.decoder
    B, S, _ = embeds.shape
    device = embeds.device
    length = length.to(device)
    positions = torch.arange(S, device=device)[None, :].expand(B, S)
    cos, sin, rot = _rope_tables(dec, positions)

    # causal AND within true length
    q_pos = positions[:, None, None, :, None]
    k_pos = positions[:, None, None, None, :]
    causal = k_pos <= q_pos
    in_len = k_pos < length[:, None, None, None, None]
    mask_bias = torch.where(causal & in_len, 0.0, NEG_INF).float()

    h = embeds
    ks, vs = [], []
    for i in range(dec.n_layers):
        h, (k, v) = _decoder_layer_prefill(
            h, _layer(params["decoder"]["layers"], i), dec, cos, sin, rot, mask_bias
        )
        ks.append(k)
        vs.append(v)
    last_idx = torch.clamp(length.long() - 1, min=0)
    h_last = h[torch.arange(B, device=device), last_idx]
    return torch.stack(ks), torch.stack(vs), _lm_logits(params, cfg, h_last)


def prefill(
    params: Params,
    cfg: GlmAsrConfig,
    embeds: torch.Tensor,  # [B, S, D] zero-padded prompt embeddings
    length: torch.Tensor,  # [B] true prompt lengths
    cache: Cache,
) -> Tuple[Cache, torch.Tensor]:
    """Run the prompt through the decoder, writing cache[:, :, :S] in place.

    Returns (cache, last_logits [B, V]) — see prefill_kv.
    """
    S = embeds.shape[1]
    max_len = cache["k"].shape[2]
    if max_len - S < 0:
        raise ValueError(f"prompt length {S} exceeds cache capacity {max_len}")
    ks, vs, last_logits = prefill_kv(params, cfg, embeds, length)
    cache["k"][:, :, :S] = ks.to(cache["k"].dtype)
    cache["v"][:, :, :S] = vs.to(cache["v"].dtype)
    cache["len"].copy_(length)
    return cache, last_logits


def decode_step(
    params: Params,
    cfg: GlmAsrConfig,
    cache: Cache,
    tokens: torch.Tensor,  # [B] current input tokens
    active: torch.Tensor | None = None,  # [B] bool; inactive rows don't advance
) -> Tuple[Cache, torch.Tensor]:
    """One autoregressive step for the whole decode batch. Returns f32 logits.

    Each layer writes the current K/V at position len IN PLACE (the JAX
    package's in-scan write), then attends over positions <= len through
    ops.decode_attention. A row whose cache is full (len == max_len) has its
    write dropped, as JAX's mode="drop" does; inactive rows are written too
    but do not advance len.
    """
    dec = cfg.decoder
    B = tokens.shape[0]
    k_all, v_all = cache["k"], cache["v"]
    max_len = k_all.shape[2]
    device = k_all.device
    pos = cache["len"]  # [B] position to write
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=device)

    x = embed_tokens(params, tokens)  # [B, D]
    cos, sin, rot = _rope_tables(dec, pos)  # [B, rot//2]

    # torch indexing has no drop mode: rows past the end rewrite their own
    # last entry with its old value instead
    rows = torch.arange(B, device=device)
    write_at = torch.clamp(pos.long(), max=max_len - 1)
    in_range = (pos < max_len)[:, None, None]

    # the JAX package's _decode_mm: W8A8 when the config selects it
    mm = matmul_w8a8 if dec.act_int8_decode else matmul
    h = x
    for i in range(dec.n_layers):
        lp = _layer(params["decoder"]["layers"], i, whole_qtensors=True)
        k_cache, v_cache = k_all[i], v_all[i]
        hn = _rms_norm(h, lp["ln1_scale"], dec.rms_eps)
        q, k_new, v_new = _decoder_qkv(lp, hn, dec, mm)
        q = _apply_rope(q[:, None], cos[:, None], sin[:, None], rot)[:, 0]
        k_new = _apply_rope(k_new[:, None], cos[:, None], sin[:, None], rot)[:, 0]
        # match the numerics of reading the stored (cache-dtype) K/V back
        k_new = k_new.to(k_cache.dtype)
        v_new = v_new.to(v_cache.dtype)
        k_cache[rows, write_at] = torch.where(in_range, k_new, k_cache[rows, write_at])
        v_cache[rows, write_at] = torch.where(in_range, v_new, v_cache[rows, write_at])

        ctx = decode_attention(q, k_cache, v_cache, pos).to(h.dtype)
        h = h + mm(ctx, lp["o_w"])
        h = _decoder_layer_mlp(h, lp, dec, mm)

    # in place: a CUDA graph of the step carries len from one replay to the next
    cache["len"].copy_(torch.where(active, torch.clamp(pos + 1, max=max_len), pos))
    return cache, _lm_logits(params, cfg, h)


def verify_step(
    params: Params,
    cfg: GlmAsrConfig,
    cache: Cache,
    tokens: torch.Tensor,  # [B, W1]: x_0 (the last emitted token) + W draft tokens
) -> Tuple[Cache, torch.Tensor]:
    """One speculative verification step: W1 query positions per slot in
    one forward pass. -> (cache, logits [B, W1, V] float32); logits[:, j] is
    the next-token distribution after x_0..x_j, the pick the sequential
    decode_step would make there.

    K/V of all W1 inputs are written IN PLACE at positions len..len+W1-1,
    as the JAX package's verify_step writes them (the same QKV and RoPE
    helpers as decode_step, K/V cast to the cache dtype before attention);
    query j attends to the positions <= len+j through
    ops.decode_attention.verify_attention. ``cache["len"]`` is left as it
    was: the caller advances it by what it accepts.

    JAX drops the writes past the cache's end (mode="drop"). Here they are
    aimed at position max_len-1, each carrying the value the row's
    in-range write puts there (or the value already there when the row has
    none), so that duplicate indices store equal values whatever order the
    device writes them in.
    """
    dec = cfg.decoder
    B, W1 = tokens.shape
    k_all, v_all = cache["k"], cache["v"]
    max_len = k_all.shape[2]
    device = k_all.device
    pos0 = cache["len"]  # [B]
    j_idx = torch.arange(W1, device=device)
    qpos = pos0.long()[:, None] + j_idx[None, :]  # [B, W1]

    x = embed_tokens(params, tokens)  # [B, W1, D]
    cos, sin, rot = _rope_tables(dec, qpos)  # [B, W1, rot//2]

    rows = torch.arange(B, device=device)[:, None]
    write_at = torch.clamp(qpos, max=max_len - 1)
    # the input each write takes: its own, or for a write past the end the
    # one that lands on max_len-1 in range (j = max_len-1-len)
    j_last = torch.clamp(max_len - 1 - pos0.long(), 0, W1 - 1)
    src = torch.where(qpos < max_len, j_idx[None, :], j_last[:, None])
    src = src[:, :, None, None].expand(B, W1, dec.n_kv_heads, dec.head_dim)
    full = (pos0 >= max_len)[:, None, None, None]  # no write in range: keep the old value

    mm = matmul_w8a8 if dec.act_int8_decode else matmul
    h = x
    for i in range(dec.n_layers):
        lp = _layer(params["decoder"]["layers"], i, whole_qtensors=True)
        k_cache, v_cache = k_all[i], v_all[i]
        hn = _rms_norm(h, lp["ln1_scale"], dec.rms_eps)
        q, k_new, v_new = _decoder_qkv(lp, hn, dec, mm)  # [B, W1, nh | nkv, hd]
        q = _apply_rope(q, cos, sin, rot)
        k_new = _apply_rope(k_new, cos, sin, rot).to(k_cache.dtype)
        v_new = v_new.to(v_cache.dtype)
        k_cache[rows, write_at] = torch.where(full, k_cache[rows, write_at], k_new.gather(1, src))
        v_cache[rows, write_at] = torch.where(full, v_cache[rows, write_at], v_new.gather(1, src))

        ctx = verify_attention(q, k_cache, v_cache, pos0).to(h.dtype)  # [B, W1, nh*hd]
        h = h + mm(ctx, lp["o_w"])
        h = _decoder_layer_mlp(h, lp, dec, mm)
    return cache, _lm_logits(params, cfg, h)


# =====================================================================
# Convenience: whole-prompt greedy generation (file path / tests)
# =====================================================================


def greedy_generate(
    params: Params,
    cfg: GlmAsrConfig,
    embeds: torch.Tensor,  # [B, S, D]
    length: torch.Tensor,  # [B]
    max_new_tokens: int,
    logit_bias: torch.Tensor | None = None,  # [V] additive bias (hotwords)
) -> Tuple[torch.Tensor, int]:
    """Greedy decode (do_sample=False parity, reference asr.py:414).

    -> (tokens [B, max_new_tokens] int32, pad-filled after EOS; the number
    of decode steps run). The tokens equal the JAX package's
    greedy_generate; the loop stops once every row has emitted EOS, where
    JAX runs all max_new_tokens steps and only emits pads after it.
    """
    B, S, _ = embeds.shape
    device = embeds.device
    cache = init_cache(cfg, B, S + max_new_tokens, dtype=embeds.dtype, device=device)
    cache, logits = prefill(params, cfg, embeds, length, cache)

    def pick(logits, done):
        if logit_bias is not None:
            logits = logits + logit_bias
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return torch.where(done, cfg.pad_id, tok).to(torch.int32)

    out = torch.full((B, max_new_tokens), cfg.pad_id, dtype=torch.int32, device=device)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    tok = pick(logits, done)
    steps = 0
    for i in range(max_new_tokens):
        out[:, i] = tok
        done = done | (tok == cfg.eos_id)
        if i == max_new_tokens - 1 or bool(done.all()):
            break  # every later token is a pad
        cache, logits = decode_step(params, cfg, cache, tok, active=~done)
        steps += 1
        tok = pick(logits, done)
    return out, steps
