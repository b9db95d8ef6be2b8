"""A reader and a writer for the safetensors format, with numpy only.

Layout: an 8-byte little-endian header length, a JSON header that maps
each tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(offsets relative to the end of the header), then the raw little-endian
buffers. ``__metadata__`` is skipped on reading. BF16, which numpy has no
type for, is widened to float32 exactly on reading and rounded to nearest
even from float32 on writing.
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


def _f32_to_bf16(arr: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bits (uint16), rounded to nearest even; a NaN stays a
    quiet NaN."""
    bits = np.ascontiguousarray(arr, dtype="<f4").view("<u4")
    out = ((bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) >> 16).astype("<u2")
    nan = np.isnan(arr)
    out[nan] = ((bits[nan] >> 16) | np.uint32(0x40)).astype("<u2")
    return out


def save_file(tensors: dict[str, np.ndarray], path: str, dtype: str = "F32") -> None:
    """Writes ``tensors`` (numpy arrays) as one ``.safetensors`` file: each
    floating array as ``dtype`` ("F32" or "BF16"), every other array in its
    own type."""
    if dtype not in ("F32", "BF16"):
        raise ValueError(f"unsupported dtype {dtype}; use F32 or BF16")
    codes = {v: k for k, v in _DTYPES.items()}
    header: dict = {}
    buffers, offset = [], 0
    for name, arr in tensors.items():
        arr = np.asarray(arr)
        if np.issubdtype(arr.dtype, np.floating):
            code = dtype
            raw = (_f32_to_bf16(arr) if dtype == "BF16" else np.ascontiguousarray(arr, dtype="<f4")).tobytes()
        else:
            arr = np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder("<"))
            if arr.dtype not in codes:
                raise ValueError(f"tensor {name!r} has unsupported dtype {arr.dtype}")
            code, raw = codes[arr.dtype], arr.tobytes()
        header[name] = {"dtype": code, "shape": list(arr.shape), "data_offsets": [offset, offset + len(raw)]}
        buffers.append(raw)
        offset += len(raw)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the buffers start 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for raw in buffers:
            f.write(raw)
