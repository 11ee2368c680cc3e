"""GLM-ASR-Nano's forward pass in plain float32 PyTorch.

Written from the architecture, not from the port: no cache, no kernels,
no batching, no padding. One request at a time: its mel through the
Whisper-style encoder and the adapter, then the whole prompt and the
served tokens through the decoder in one causal pass. The logits at every
served position come out at once.

- encoder: two convolutions (kernel 3, padding 1; the second of stride 2)
  with exact GELU, over the true frames and two zero frames after them;
  the ceil(T / 2) true positions with sinusoidal positions added; pre-LN
  blocks (q and v biased, k not), exact-GELU MLP; a final LayerNorm;
- adapter: max(1, T // 8) audio tokens, each four stacked encoder
  positions through Linear, GELU, Linear;
- decoder: RMSNorm, GQA with a QKV bias and NeoX rotary on the first
  half of each head's dims, SwiGLU, tied embeddings.

The caller sets TF32 off (``check.strict_float32``): float32 products then run
in float32 on the card too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _f(t) -> torch.Tensor:
    return t.float()


def _sinusoids(length: int, channels: int, device) -> torch.Tensor:
    inv = torch.exp(-math.log(10000.0) / (channels // 2 - 1)
                    * torch.arange(channels // 2, dtype=torch.float64, device=device))
    ang = torch.arange(length, dtype=torch.float64, device=device)[:, None] * inv[None]
    return torch.cat([ang.sin(), ang.cos()], dim=1).float()


def encode(W: dict, m: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel [T, n_mels] -> audio tokens [max(1, T // 8), d_decoder]."""
    enc = m["encoder"]
    p = W["encoder"]
    T = mel.shape[0]
    x = F.pad(mel.float(), (0, 0, 0, 2)).T[None]  # [1, n_mels, T + 2]
    x = F.gelu(F.conv1d(x, _f(p["conv1"]["w"]).permute(2, 1, 0), _f(p["conv1"]["b"]),
                        padding=1))
    x = F.gelu(F.conv1d(x, _f(p["conv2"]["w"]).permute(2, 1, 0), _f(p["conv2"]["b"]),
                        stride=2, padding=1))
    S = (T + 1) // 2
    x = x[0].T[:S]  # [S, D]
    D = x.shape[1]
    x = x + _sinusoids(S, D, x.device)
    nh = enc["n_heads"]
    hd = D // nh
    L = p["layers"]
    for i in range(enc["n_layers"]):
        h = F.layer_norm(x, (D,), _f(L["ln1_scale"][i]), _f(L["ln1_bias"][i]), 1e-5)
        q = (h @ _f(L["q_w"][i]) + _f(L["q_b"][i])).view(S, nh, hd).transpose(0, 1)
        k = (h @ _f(L["k_w"][i])).view(S, nh, hd).transpose(0, 1)
        v = (h @ _f(L["v_w"][i]) + _f(L["v_b"][i])).view(S, nh, hd).transpose(0, 1)
        att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(hd), dim=-1)
        ctx = (att @ v).transpose(0, 1).reshape(S, D)
        x = x + ctx @ _f(L["o_w"][i]) + _f(L["o_b"][i])
        h = F.layer_norm(x, (D,), _f(L["ln2_scale"][i]), _f(L["ln2_bias"][i]), 1e-5)
        x = x + F.gelu(h @ _f(L["fc1_w"][i]) + _f(L["fc1_b"][i])) @ _f(L["fc2_w"][i]) \
            + _f(L["fc2_b"][i])
    x = F.layer_norm(x, (D,), _f(p["ln_post_scale"]), _f(p["ln_post_bias"]), 1e-5)
    k = m["adapter_stack"]
    n_tok = max(1, T // (2 * k))
    if x.shape[0] < n_tok * k:
        x = F.pad(x, (0, 0, 0, n_tok * k - x.shape[0]))
    x = x[: n_tok * k].reshape(n_tok, k * D)
    a = W["adapter"]
    x = F.gelu(x @ _f(a["fc1"]["w"]) + _f(a["fc1"]["b"]))
    return x @ _f(a["fc2"]["w"]) + _f(a["fc2"]["b"])


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * _f(scale)


def _rope(x: torch.Tensor, positions: torch.Tensor, dec: dict) -> torch.Tensor:
    """x [S, H, hd]: NeoX halves over the first hd * partial dims."""
    rot = int(dec["head_dim"] * dec["partial_rotary_factor"])
    inv = 1.0 / (dec["rope_theta"] ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                                    device=x.device) / rot))
    ang = positions.float()[:, None] * inv[None]
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    a, b = x[..., : rot // 2], x[..., rot // 2 : rot]
    return torch.cat([a * cos - b * sin, b * cos + a * sin, x[..., rot:]], dim=-1)


def _decoder_layer(x: torch.Tensor, Li: dict, dec: dict, pos: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    S = x.shape[0]
    nh, nkv, hd, eps = dec["n_heads"], dec["n_kv_heads"], dec["head_dim"], dec["rms_eps"]
    h = _rms(x, Li["ln1_scale"], eps)
    qkv = h @ _f(Li["qkv_w"]) + _f(Li["qkv_b"])
    q = _rope(qkv[:, : nh * hd].view(S, nh, hd), pos, dec)
    k = _rope(qkv[:, nh * hd : (nh + nkv) * hd].view(S, nkv, hd), pos, dec)
    v = qkv[:, (nh + nkv) * hd :].view(S, nkv, hd)
    k = k.repeat_interleave(nh // nkv, dim=1).transpose(0, 1)
    v = v.repeat_interleave(nh // nkv, dim=1).transpose(0, 1)
    att = q.transpose(0, 1) @ k.transpose(1, 2) / math.sqrt(hd) + mask
    ctx = (torch.softmax(att, dim=-1) @ v).transpose(0, 1).reshape(S, nh * hd)
    x = x + ctx @ _f(Li["o_w"])
    h = _rms(x, Li["ln2_scale"], eps)
    gate, up = (h @ _f(Li["gate_up_w"])).chunk(2, dim=-1)
    return x + (F.silu(gate) * up) @ _f(Li["down_w"])


def decoder_logits(W: dict, m: dict, embeds: torch.Tensor, at: torch.Tensor,
                   layers=None) -> torch.Tensor:
    """embeds [S, D] -> float32 logits [len(at), V] at positions `at`,
    each from a causal pass over positions 0..at. `layers`: the decoder's
    layers in order, one dict of unstacked leaves at a time (default: W's
    stack), for a caller that makes each layer's leaves only when it runs."""
    dec = m["decoder"]
    p = W["decoder"]
    S = embeds.shape[0]
    pos = torch.arange(S, device=embeds.device)
    mask = torch.full((S, S), float("-inf"), device=embeds.device).triu(1)
    x = embeds.float()
    if layers is None:
        layers = ({k: v[i] for k, v in p["layers"].items()} for i in range(dec["n_layers"]))
    for Li in layers:
        x = _decoder_layer(x, Li, dec, pos, mask)
    h = _rms(x[at], p["ln_f_scale"], dec["rms_eps"])
    return h @ _f(p["embed"]).T


def served_logits(W: dict, m: dict, mel: torch.Tensor, prefix: list, suffix: list,
                  tokens: list, layers=None) -> torch.Tensor:
    """The logits [len(tokens), V] that chose each served token: the
    prompt (prefix, audio tokens, suffix) and tokens[:-1] in one pass
    (`layers` as in ``decoder_logits``)."""
    emb = _f(W["decoder"]["embed"])
    dev = emb.device
    audio = encode(W, m, mel)
    ids = lambda xs: torch.as_tensor(list(xs), dtype=torch.long, device=dev)  # noqa: E731
    embeds = torch.cat([emb[ids(prefix)], audio, emb[ids(suffix)], emb[ids(tokens[:-1])]])
    first = len(prefix) + audio.shape[0] + len(suffix) - 1
    return decoder_logits(W, m, embeds, torch.arange(first, first + len(tokens), device=dev),
                          layers)
