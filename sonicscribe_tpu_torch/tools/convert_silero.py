"""Silero-VAD weight conversion: upstream checkpoint -> SileroVad params.

The port's counterpart of the JAX package's ``tools/convert_silero.py``,
the same table and the same npz layout, so that a file written by either
package loads in the other. An upstream state dict maps onto
``vad/model.py:SileroVad``'s params (the JAX layout: conv weights [k, in,
out], dense [in, out], one LSTM bias). Leaves come out as numpy; SileroVad
moves them to its device.

    python -m sonicscribe_tpu_torch.tools.convert_silero <silero.jit|.pt> <out.npz>

Serve the result with ``--vad <out.npz>`` or ``SONIC_SILERO_WEIGHTS``. If
upstream layer names differ from SILERO_NAME_CANDIDATES, the error lists
the keys found so that the table can be extended.
"""

from __future__ import annotations

import numpy as np

from sonicscribe_tpu_torch.vad.model import SileroConfig

# our param path -> candidate upstream names (first match wins); conv weights
# are [out, in, k] in torch -> [k, in, out] here; dense are [out, in] -> [in, out]
SILERO_NAME_CANDIDATES: dict[str, list[str]] = {
    "stft.basis": [
        "_model.stft.forward_basis_buffer",
        "stft.forward_basis_buffer",
        "stft.basis",
    ],
    "convs.0.w": ["encoder.0.reparam_conv.weight", "encoder.0.weight", "first_layer.weight"],
    "convs.0.b": ["encoder.0.reparam_conv.bias", "encoder.0.bias", "first_layer.bias"],
    "convs.1.w": ["encoder.1.reparam_conv.weight", "encoder.1.weight"],
    "convs.1.b": ["encoder.1.reparam_conv.bias", "encoder.1.bias"],
    "convs.2.w": ["encoder.2.reparam_conv.weight", "encoder.2.weight"],
    "convs.2.b": ["encoder.2.reparam_conv.bias", "encoder.2.bias"],
    "convs.3.w": ["encoder.3.reparam_conv.weight", "encoder.3.weight"],
    "convs.3.b": ["encoder.3.reparam_conv.bias", "encoder.3.bias"],
    "lstm.wi": ["decoder.rnn.weight_ih", "lstm.weight_ih_l0"],
    "lstm.wh": ["decoder.rnn.weight_hh", "lstm.weight_hh_l0"],
    "lstm.b": ["decoder.rnn.bias_ih", "lstm.bias_ih_l0"],
    "lstm.b2": ["decoder.rnn.bias_hh", "lstm.bias_hh_l0"],  # summed into b
    "out.w": ["decoder.decoder.2.weight", "out.weight"],
    "out.b": ["decoder.decoder.2.bias", "out.bias"],
}


class SileroMappingError(KeyError):
    pass


def convert_state_dict(sd: dict[str, np.ndarray], cfg: SileroConfig | None = None) -> dict:
    """Upstream state dict (numpy values) -> SileroVad params tree.

    The upstream jit export nests the 16 kHz graph under `_model.` and ships
    a parallel 8 kHz graph under `_model_8k.`; both prefixes are normalized
    away first so that the candidate table matches either layout."""
    cfg = cfg or SileroConfig()
    norm = {}
    for k, v in sd.items():
        if k.startswith("_model_8k."):
            continue  # the 8 kHz twin graph: not used (16 kHz only)
        norm[k.removeprefix("_model.")] = v
    sd = norm

    def fetch(ours: str, optional: bool = False):
        for cand in SILERO_NAME_CANDIDATES[ours]:
            if cand in sd:
                return np.asarray(sd[cand], np.float32)
        if optional:
            return None
        raise SileroMappingError(
            f"no upstream tensor found for '{ours}' "
            f"(tried {SILERO_NAME_CANDIDATES[ours]}); available keys: "
            f"{sorted(sd)[:20]}..."
        )

    convs = []
    for i in range(len(cfg.conv_channels)):
        w = fetch(f"convs.{i}.w")  # [out, in, k] -> [k, in, out]
        convs.append({"w": np.transpose(w, (2, 1, 0)), "b": fetch(f"convs.{i}.b")})

    b = fetch("lstm.b")
    b2 = fetch("lstm.b2", optional=True)
    if b2 is not None:
        b = b + b2
    out_w = fetch("out.w")
    if out_w.ndim == 3:  # conv1d head [1, h, 1]
        out_w = out_w[:, :, 0]
    params = {
        "convs": convs,
        "lstm": {"wi": fetch("lstm.wi").T, "wh": fetch("lstm.wh").T, "b": b},
        "out": {"w": out_w.T, "b": fetch("out.b")},
    }
    basis = fetch("stft.basis", optional=True)
    if basis is not None:
        if basis.ndim == 3:  # upstream conv buffer [2*bins, 1, n_fft]
            basis = basis[:, 0, :]
        params["stft"] = {"basis": basis}
    return params


def load_torch_checkpoint(path: str) -> dict[str, np.ndarray]:
    """An upstream `.jit` (TorchScript) or a torch state-dict file ->
    {name: float32 numpy}."""
    import torch

    if path.endswith(".jit"):
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    return {k: v.float().numpy() for k, v in sd.items()}


def to_flat(params: dict) -> dict[str, np.ndarray]:
    """The params tree -> the npz's flat `convs.i.w` / `lstm.wi` / ... keys."""
    flat = {}
    for i, c in enumerate(params["convs"]):
        flat[f"convs.{i}.w"], flat[f"convs.{i}.b"] = c["w"], c["b"]
    for k in ("wi", "wh", "b"):
        flat[f"lstm.{k}"] = params["lstm"][k]
    flat["out.w"], flat["out.b"] = params["out"]["w"], params["out"]["b"]
    if "stft" in params:
        flat["stft.basis"] = params["stft"]["basis"]
    return {k: np.asarray(v, np.float32) for k, v in flat.items()}


def load_npz(path: str) -> dict:
    """Load a converted silero npz back into the params tree (numpy)."""
    with np.load(path) as z:
        n_convs = sum(1 for k in z.files if k.endswith(".w") and k.startswith("convs"))
        params = {
            "convs": [{"w": z[f"convs.{i}.w"], "b": z[f"convs.{i}.b"]} for i in range(n_convs)],
            "lstm": {"wi": z["lstm.wi"], "wh": z["lstm.wh"], "b": z["lstm.b"]},
            "out": {"w": z["out.w"], "b": z["out.b"]},
        }
        if "stft.basis" in z.files:
            params["stft"] = {"basis": z["stft.basis"]}
        return params


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Convert Silero-VAD weights to the npz layout")
    ap.add_argument("src", help="upstream silero_vad.jit or a torch state-dict file")
    ap.add_argument("dst", help="the .npz to write")
    args = ap.parse_args(argv)
    flat = to_flat(convert_state_dict(load_torch_checkpoint(args.src)))
    np.savez(args.dst, **flat)
    print(f"converted {len(flat)} tensors -> {args.dst}")


if __name__ == "__main__":
    main()
