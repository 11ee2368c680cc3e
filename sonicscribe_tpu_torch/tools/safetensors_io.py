"""Read and write the safetensors format without the safetensors package.

A file is an 8-byte little-endian header length, a JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}}`` padded with spaces to a multiple of 8 bytes, then the raw
little-endian bytes of every tensor, back to back. HF checkpoints of this
size usually store BF16, which numpy has no type for: its bytes are read as
uint16 and viewed as ``torch.bfloat16``. Tensors come back as CPU torch
tensors, their dtype the file's.

The card machine has no safetensors package, so the checkpoint tools read
and write through this module.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

# safetensors dtype -> (numpy dtype of its bytes, torch dtype)
DTYPES = {
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I8": (np.int8, torch.int8),
}
_BY_TORCH = {t: name for name, (_, t) in DTYPES.items()}


def _read_header(f) -> tuple[dict, int]:
    (n,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(n))
    return header, 8 + n


def read_shapes(path: str) -> dict[str, tuple[int, ...]]:
    """Every tensor's shape from the header alone (no tensor data read)."""
    with open(path, "rb") as f:
        header, _ = _read_header(f)
    return {k: tuple(v["shape"]) for k, v in header.items() if k != "__metadata__"}


def load_file(path: str) -> dict[str, torch.Tensor]:
    """-> {name: CPU tensor} in the file's dtypes (BF16 as torch.bfloat16),
    each tensor read from the file on its own."""
    out = {}
    with open(path, "rb") as f:
        header, start = _read_header(f)
        f.seek(0, 2)
        n_data = f.tell() - start
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if info["dtype"] not in DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                                 f"not one of {sorted(DTYPES)}")
            np_dtype, torch_dtype = DTYPES[info["dtype"]]
            item = np.dtype(np_dtype).itemsize
            begin, end = info["data_offsets"]
            shape = tuple(info["shape"])
            count = int(np.prod(shape, dtype=np.int64))
            if end - begin != count * item or end > n_data:
                raise ValueError(f"{path}: tensor {name!r} spans bytes {begin}-{end} of "
                                 f"{n_data} after the header, {count * item} expected")
            f.seek(start + begin)
            arr = np.fromfile(f, dtype=np.dtype(np_dtype).newbyteorder("<"), count=count)
            arr = arr.astype(np_dtype, copy=False).reshape(shape)  # native byte order
            if info["dtype"] == "BF16":
                out[name] = torch.from_numpy(arr.view(np.int16)).view(torch_dtype)
            else:
                out[name] = torch.from_numpy(arr)
    return out


def _raw(v) -> tuple[str, tuple[int, ...], bytes]:
    """A tensor or an array -> (safetensors dtype, shape, little-endian bytes)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype not in _BY_TORCH:
            raise ValueError(f"dtype {t.dtype} has no safetensors name")
        name = _BY_TORCH[t.dtype]
        arr = t.view(torch.int16).numpy() if name == "BF16" else t.numpy()
    else:
        arr = np.asarray(v)
        matches = [k for k, (d, _) in DTYPES.items() if d == arr.dtype and k != "BF16"]
        if not matches:
            raise ValueError(f"dtype {arr.dtype} has no safetensors name")
        name = matches[0]
    return name, tuple(arr.shape), arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()


def save_file(tensors: dict, path: str, metadata: dict[str, str] | None = None) -> None:
    """{name: tensor or array} -> a safetensors file, tensors in name order."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name in sorted(tensors):
        dtype, shape, raw = _raw(tensors[name])
        header[name] = {"dtype": dtype, "shape": list(shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
