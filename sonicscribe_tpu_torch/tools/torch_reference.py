"""Independent PyTorch reference of the GLM-ASR forward pass.

The port's own copy of the JAX package's ``tools/torch_reference.py`` (only
the config import differs). It follows the architecture spec, not the
port's model code: plain full-context loops on the CPU in float32 over a
tree of numpy leaves, no KV cache, no kernels, so that a fault shared by
the port's model code shows up as a token mismatch.
``tools/verify_checkpoint.py``'s twin step holds the port's Transcriber to
its greedy tokens on the same converted tree.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from sonicscribe_tpu_torch.models.config import GlmAsrConfig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32))


def _layer_norm(x, scale, bias, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), _t(scale), _t(bias), eps)


def _rms_norm(x, scale, eps):
    v = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return v * _t(scale)


def _sinusoids(length, channels):
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2))
    ang = torch.arange(length)[:, None].float() * inv[None]
    return torch.cat([ang.sin(), ang.cos()], dim=1)


def _rope(x, positions, head_dim, partial, theta):
    """x: [S, H, hd], positions: [S]. NeoX half-split on first rot dims."""
    rot = int(head_dim * partial)
    inv_freq = 1.0 / (theta ** (torch.arange(0, rot, 2).float() / rot))
    ang = positions[:, None].float() * inv_freq[None]  # [S, rot/2]
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2, rest = x[..., : rot // 2], x[..., rot // 2 : rot], x[..., rot:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], dim=-1)


@torch.no_grad()
def encode_audio_torch(params: dict, cfg: GlmAsrConfig, mel: np.ndarray) -> torch.Tensor:
    """mel: [T, n_mels] (true frames only) -> audio embeds [A, d_lm]."""
    enc = cfg.encoder
    p = params["encoder"]
    x = _t(mel)[None].transpose(1, 2)  # [1, n_mels, T]

    w1 = _t(p["conv1"]["w"]).permute(2, 1, 0)  # [K,in,out]->[out,in,K]
    x = F.gelu(F.conv1d(x, w1, _t(p["conv1"]["b"]), stride=1, padding=1))
    w2 = _t(p["conv2"]["w"]).permute(2, 1, 0)
    x = F.gelu(F.conv1d(x, w2, _t(p["conv2"]["b"]), stride=2, padding=1))
    x = x.transpose(1, 2)[0]  # [S, D]
    S, D = x.shape
    x = x + _sinusoids(S, D)

    nh = enc.n_heads
    hd = D // nh
    L = p["layers"]
    for i in range(enc.n_layers):
        h = _layer_norm(x, L["ln1_scale"][i], L["ln1_bias"][i])
        q = (h @ _t(L["q_w"][i]) + _t(L["q_b"][i])).view(S, nh, hd)
        k = (h @ _t(L["k_w"][i])).view(S, nh, hd)
        v = (h @ _t(L["v_w"][i]) + _t(L["v_b"][i])).view(S, nh, hd)
        att = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
        ctx = torch.einsum("hqk,khd->qhd", att.softmax(-1), v).reshape(S, D)
        x = x + ctx @ _t(L["o_w"][i]) + _t(L["o_b"][i])
        h = _layer_norm(x, L["ln2_scale"][i], L["ln2_bias"][i])
        h = F.gelu(h @ _t(L["fc1_w"][i]) + _t(L["fc1_b"][i]))
        x = x + h @ _t(L["fc2_w"][i]) + _t(L["fc2_b"][i])
    x = _layer_norm(x, p["ln_post_scale"], p["ln_post_bias"])

    k = cfg.adapter_stack
    A = S // k
    x = x[: A * k].reshape(A, k * D)
    a = params["adapter"]
    x = F.gelu(x @ _t(a["fc1"]["w"]) + _t(a["fc1"]["b"]))
    return x @ _t(a["fc2"]["w"]) + _t(a["fc2"]["b"])


@torch.no_grad()
def decoder_logits_torch(
    params: dict, cfg: GlmAsrConfig, embeds: torch.Tensor
) -> torch.Tensor:
    """Full-context causal forward. embeds: [S, D] -> logits [S, V] f32."""
    dec = cfg.decoder
    p = params["decoder"]
    L = p["layers"]
    S, D = embeds.shape
    nh, nkv, hd = dec.n_heads, dec.n_kv_heads, dec.head_dim
    positions = torch.arange(S)
    causal = torch.tril(torch.ones(S, S, dtype=torch.bool))

    x = embeds
    for i in range(dec.n_layers):
        h = _rms_norm(x, L["ln1_scale"][i], dec.rms_eps)
        qkv = h @ _t(L["qkv_w"][i])
        if dec.qkv_bias:
            qkv = qkv + _t(L["qkv_b"][i])
        q = qkv[:, : nh * hd].view(S, nh, hd)
        k = qkv[:, nh * hd : (nh + nkv) * hd].view(S, nkv, hd)
        v = qkv[:, (nh + nkv) * hd :].view(S, nkv, hd)
        q = _rope(q, positions, hd, dec.partial_rotary_factor, dec.rope_theta)
        k = _rope(k, positions, hd, dec.partial_rotary_factor, dec.rope_theta)
        # GQA: repeat kv heads
        rep = nh // nkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        att = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
        att = att.masked_fill(~causal[None], float("-inf")).softmax(-1)
        ctx = torch.einsum("hqk,khd->qhd", att, v).reshape(S, nh * hd)
        x = x + ctx @ _t(L["o_w"][i])
        h = _rms_norm(x, L["ln2_scale"][i], dec.rms_eps)
        gu = h @ _t(L["gate_up_w"][i])
        gate, up = gu.chunk(2, dim=-1)
        x = x + (F.silu(gate) * up) @ _t(L["down_w"][i])

    x = _rms_norm(x, p["ln_f_scale"], dec.rms_eps)
    w = _t(p["embed"]).T if dec.tie_embeddings else _t(p["lm_head"])
    return x @ w


@torch.no_grad()
def greedy_decode_torch(
    params: dict,
    cfg: GlmAsrConfig,
    prompt_embeds: torch.Tensor,  # [P, D]
    max_new_tokens: int,
) -> list[int]:
    """Greedy decode by full-context re-forward each step (slow, simple,
    structurally independent of the KV-cache decode)."""
    embed = _t(params["decoder"]["embed"])
    embeds = prompt_embeds
    out: list[int] = []
    for _ in range(max_new_tokens):
        logits = decoder_logits_torch(params, cfg, embeds)
        tok = int(logits[-1].argmax())
        out.append(tok)
        if tok == cfg.eos_id:
            break
        embeds = torch.cat([embeds, embed[tok][None]], dim=0)
    return out


@torch.no_grad()
def transcribe_torch(
    params: dict,
    cfg: GlmAsrConfig,
    mel: np.ndarray,  # [T, n_mels] true frames
    prefix_ids: np.ndarray,
    suffix_ids: np.ndarray,
    max_new_tokens: int,
) -> list[int]:
    """Full pipeline: audio embeds + prompt -> greedy tokens."""
    embed = _t(params["decoder"]["embed"])
    audio = encode_audio_torch(params, cfg, mel)
    prompt = torch.cat(
        [embed[np.asarray(prefix_ids)], audio, embed[np.asarray(suffix_ids)]]
    )
    return greedy_decode_torch(params, cfg, prompt, max_new_tokens)
