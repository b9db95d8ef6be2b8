"""A reader for the safetensors format, with numpy only.

Layout: an 8-byte little-endian header length, a JSON header that maps
each tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(offsets relative to the end of the header), then the raw little-endian
buffers. ``__metadata__`` is skipped. BF16, which numpy has no type for,
is widened to float32 exactly.
"""

import json
import struct

import numpy as np

_DTYPES = {
    "F64": np.dtype("<f8"),
    "F32": np.dtype("<f4"),
    "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"),
    "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"),
    "U8": np.dtype("u1"),
    "BOOL": np.dtype("?"),
}
_MAX_HEADER = 100 * 1024 * 1024


def _bf16_to_f32(raw: bytes, shape) -> np.ndarray:
    half = np.frombuffer(raw, dtype="<u2").astype(np.uint32)
    return (half << 16).view(np.float32).reshape(shape)


def load_file(path: str) -> dict[str, np.ndarray]:
    """All tensors of a ``.safetensors`` file as numpy arrays."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        if n > _MAX_HEADER:
            raise ValueError(f"{path}: header of {n} bytes is not safetensors")
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        if not 0 <= begin <= end <= len(data):
            raise ValueError(f"{path}: tensor {name!r} lies outside the file")
        raw = data[begin:end]
        shape = tuple(info["shape"])
        dtype = info["dtype"]
        if dtype == "BF16":
            arr = _bf16_to_f32(raw, shape)
        elif dtype in _DTYPES:
            arr = np.frombuffer(raw, dtype=_DTYPES[dtype]).reshape(shape)
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {dtype}")
        out[name] = arr
    return out
