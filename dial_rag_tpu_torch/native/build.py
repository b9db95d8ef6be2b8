"""Builds the port's C++ host cores (``native/*.cpp``) and loads them.

Each core is compiled by ``g++ -O3 -std=c++17 -shared -fPIC -pthread``
into its own shared library with a plain C interface, loaded with
``ctypes``, at first use. The library goes to
``dial_rag_tpu_torch/_build/native/<name>-<hash>.so``, the hash covering
the source and the flags. g++ writes under a temporary name and the file
is renamed into place, so a build that was cut off leaves no file that a
later run would take for a finished one, and no lock. A build that fails
or runs past its time limit raises: no caller falls back to the Python
path because a core is missing.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC_DIR = Path(__file__).resolve().parent
_BUILD_DIR = _SRC_DIR.parent / "_build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_GXX_TIMEOUT_S = 300

_P = ctypes.c_void_p
_INT_P = ctypes.POINTER(ctypes.c_int)
# (argtypes, restype) of the entry points, by source stem
SIGNATURES = {
    "chargram": {
        # (words, word_lens [n_words], n_words, chunk_word_counts [n_chunks],
        #  n_chunks, n_lo, n_hi, out_chunk, out_key, out_cnt, out_cap, n_threads)
        "chargram_triples": (
            [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong, ctypes.POINTER(ctypes.c_int32),
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
             ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong, ctypes.c_int],
            ctypes.c_longlong,
        ),
    },
    "keywords": {
        "kw_set_stopwords": ([ctypes.c_char_p, ctypes.c_int32], None),
        "kw_preprocess": (
            [ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32],
            ctypes.c_int32,
        ),
    },
    "wordpiece": {
        "wp_create": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_int], _P),
        "wp_free": ([_P], None),
        # (handle, texts, offsets [n + 1], n, out_ids [n, stride], stride,
        #  cls_id, sep_id, pad_id, out_lens [n])
        "wp_encode_batch": (
            [_P, ctypes.c_char_p, _INT_P, ctypes.c_int, _INT_P, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, _INT_P],
            None,
        ),
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _library_path(name: str) -> Path:
    src = _SRC_DIR / f"{name}.cpp"
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(src.read_bytes())
    target = _BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if target.is_file():
        return target
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f"{target.stem}.{os.getpid()}.tmp.so"
    try:
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, str(src), "-o", str(tmp)],
            capture_output=True, text=True, timeout=_GXX_TIMEOUT_S,
        )
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"g++ build of native/{name}.cpp timed out after {_GXX_TIMEOUT_S} s") from e
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: native/{name}.cpp cannot be built") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ build of native/{name}.cpp failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, target)
    return target


def load_native(name: str) -> ctypes.CDLL:
    """The core ``native/<name>.cpp``, built once per source hash, with
    the argument and result types of its entry points set."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_library_path(name)))
            for fn_name, (argtypes, restype) in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = restype
            _loaded[name] = lib
        return lib
