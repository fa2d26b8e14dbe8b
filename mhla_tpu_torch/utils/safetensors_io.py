"""A reader of the safetensors format without the ``safetensors`` package,
shared by the Wan and T5 checkpoint loaders.

A file is an 8-byte little-endian header length n, n bytes of JSON mapping
each tensor's name to its ``dtype``, ``shape`` and ``data_offsets``
([begin, end) in the byte buffer that follows the header), and that buffer
of raw little-endian tensors; an optional ``__metadata__`` entry holds
strings.
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np
import torch

_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4", "I16": "<i2",
    "I8": "i1", "U8": "u1", "BOOL": "?",
}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of the file as a numpy array. The file is memory-mapped,
    so a tensor of a supported numpy dtype is a read-only view of it; BF16,
    which numpy lacks, becomes float32 (exactly: its bits are float32's
    upper half)."""
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
    buf = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw, shape = buf[begin:end], tuple(info["shape"])
        if info["dtype"] == "BF16":  # widened by torch's threaded cast, bit for bit
            bits = torch.from_numpy(raw.view("<i2").copy())
            out[name] = bits.view(torch.bfloat16).float().numpy().reshape(shape)
        elif info["dtype"] in _DTYPES:
            out[name] = raw.view(_DTYPES[info["dtype"]]).reshape(shape)
        else:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, which this "
                             f"reader does not read (it reads BF16 and {sorted(_DTYPES)})")
    return out
