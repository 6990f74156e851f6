"""ctypes bindings for the native C++ image decoder (native/decoder.cpp).

The port's own binding of the repository's framework-neutral decoder:
parallel JPEG/PNG decode + bilinear resize to float32 grayscale on a
pthread pool. It loads the prebuilt `native/libtpu3drec_decoder.so` by
path and builds nothing; where the library is missing or does not load
(it links libjpeg and libpng), `available()` is False and `io/images.py`
decodes with PIL.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libtpu3drec_decoder.so"
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.tpu3drec_image_size.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.tpu3drec_image_size.restype = ctypes.c_int
    lib.tpu3drec_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.tpu3drec_decode_batch.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def image_size(path) -> Optional[Tuple[int, int]]:
    """(h, w) or None on failure."""
    lib = _load()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.tpu3drec_image_size(str(path).encode(), ctypes.byref(h),
                               ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def decode_batch(paths: Sequence, sizes: Sequence[Tuple[int, int]],
                 resize_to: Optional[Tuple[int, int]] = None,
                 n_threads: int = 0) -> List[Optional[np.ndarray]]:
    """Parallel decode to float32 grayscale [0,1].

    sizes: native (h, w) per path (from image_size / metadata scan);
    resize_to: common (h, w) for all, or None for native sizes.
    Returns a list of arrays (None where decoding failed).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    n = len(paths)
    if n == 0:
        return []
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    bufs = []
    ptrs = (ctypes.POINTER(ctypes.c_float) * n)()
    cpaths = (ctypes.c_char_p * n)()
    for i, p in enumerate(paths):
        h, w = resize_to if resize_to is not None else sizes[i]
        buf = np.empty((h, w), np.float32)
        bufs.append(buf)
        ptrs[i] = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        cpaths[i] = str(p).encode()
    statuses = (ctypes.c_int * n)()
    if resize_to is not None:
        oh, ow = resize_to
        lib.tpu3drec_decode_batch(cpaths, ptrs, n, oh, ow, n_threads,
                                  statuses)
    else:
        # per-image native sizes: group identical sizes into sub-batches
        by_size = {}
        for i, s in enumerate(sizes):
            by_size.setdefault(tuple(s), []).append(i)
        for (h, w), idxs in by_size.items():
            sub_p = (ctypes.c_char_p * len(idxs))(
                *[cpaths[i] for i in idxs])
            sub_b = (ctypes.POINTER(ctypes.c_float) * len(idxs))(
                *[ptrs[i] for i in idxs])
            sub_s = (ctypes.c_int * len(idxs))()
            lib.tpu3drec_decode_batch(sub_p, sub_b, len(idxs), h, w,
                                      n_threads, sub_s)
            for k, i in enumerate(idxs):
                statuses[i] = sub_s[k]
    return [bufs[i] if statuses[i] == 0 else None for i in range(n)]
