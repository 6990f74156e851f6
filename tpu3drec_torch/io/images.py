"""Image management: metadata-only folder scans, size-bounded caching,
batch loading, and pair generation.

Port of `tpu3drec/io/images.py` (host-side, numpy): metadata scan without
pixel loads, the FIFO byte-budgeted `ImageCache`, `BatchImageLoader` that
loads only the unique uncached images of a batch, `FolderImageSource`, and
the pair-mode generators. Pixels are float32 grayscale in [0, 1].

Decoding: `.npy` files are read with numpy; JPEG and PNG go through the
native decoder (`io/native_decoder.py`) when it loads, else PIL. PIL is
imported only inside the functions that decode with it, so a machine
without PIL imports this module and reads `.npy` folders. Arrays are
resized by `resize_u8`, a numpy port of PIL's default `Image.resize` for
8-bit grayscale (bit-equal to it), so a `.npy` folder with `resize_to`
needs no PIL either.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff",
                    ".webp", ".ppm", ".pgm", ".npy"}


@dataclasses.dataclass
class ImageMetadata:
    """~500B/image instead of ~10MB of pixels."""
    name: str
    path: str
    width: int = 0
    height: int = 0
    file_size: int = 0

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


# PIL's fixed-point resampling: coefficients carry 22 fraction bits
_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic kernel (a = -0.5), support 2."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


@functools.lru_cache(maxsize=32)
def _resize_coeffs(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) int64 fixed-point weights of one axis, as PIL's
    `precompute_coeffs` + `normalize_coeffs_8bpc` build them."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ss = 1.0 / filterscale
    W = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        # C casts truncate toward zero
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax, dtype=np.float64)
        w = _bicubic(((x + xmin) - center + 0.5) * ss)
        ww = 0.0
        for v in w:          # PIL's sequential sum
            ww += v
        if ww != 0.0:
            w = w / ww
        fixed = w * (1 << _PRECISION_BITS)
        W[xx, xmin:xmin + xmax] = np.trunc(
            np.where(w < 0, fixed - 0.5, fixed + 0.5)).astype(np.int64)
    W.flags.writeable = False     # cached: shared by every caller
    return W


def _resample_pass(img: np.ndarray, W: np.ndarray, axis: int) -> np.ndarray:
    """One uint8 pass: the rounded fixed-point sums clipped to 0..255. The
    products and sums are integers below 2**53, so a float64 product is
    exact in any summation order."""
    src = img.astype(np.float64)
    acc = (src @ W.T.astype(np.float64) if axis == 1
           else W.astype(np.float64) @ src)
    acc = acc.astype(np.int64) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255)
    return np.where(acc <= 0, 0, out).astype(np.uint8)


def resize_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W) uint8 -> `size` (H', W') uint8, bit-equal to PIL's
    `Image.fromarray(img).resize((W', H'))`: the bicubic filter, support
    widened by the downscale factor, a horizontal then a vertical pass,
    each rounded and clipped to uint8."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape
    oh, ow = int(size[0]), int(size[1])
    out = img.copy()
    if ow != w:
        out = _resample_pass(out, _resize_coeffs(w, ow), axis=1)
    if oh != h:
        out = _resample_pass(out, _resize_coeffs(h, oh), axis=0)
    return out


def resize_unit(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """float image in [0, 1] -> `size`, through 8 bits as the reference
    resizes arrays: clipped, truncated to uint8, resized, over 255."""
    u8 = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    return resize_u8(u8, size).astype(np.float32) / 255.0


def _read_image(path: str, resize_to: Optional[Tuple[int, int]] = None
                ) -> np.ndarray:
    """Decode to float32 grayscale [0,1]; optional (H, W) resize."""
    p = Path(path)
    if p.suffix.lower() == ".npy":
        arr = np.load(p)
        if arr.ndim == 3:
            arr = arr @ np.array([0.299, 0.587, 0.114], arr.dtype)
        img = arr.astype(np.float32)
        if img.max() > 2.0:
            img = img / 255.0
        if resize_to is not None and img.shape != tuple(resize_to):
            img = resize_unit(img, resize_to)
        return img
    from PIL import Image
    with Image.open(p) as im:
        im = im.convert("L")
        if resize_to is not None:
            im = im.resize((resize_to[1], resize_to[0]))
        return np.asarray(im, np.float32) / 255.0


def scan_folder_metadata(folder, max_images: Optional[int] = None
                         ) -> List[ImageMetadata]:
    """Metadata-only scan (no pixel loads)."""
    folder = Path(folder)
    if not folder.is_dir():
        raise FileNotFoundError(f"Not a directory: {folder}")
    out = []
    for p in sorted(folder.iterdir()):
        if p.suffix.lower() not in IMAGE_EXTENSIONS or not p.is_file():
            continue
        meta = ImageMetadata(name=p.name, path=str(p),
                             file_size=p.stat().st_size)
        try:
            if p.suffix.lower() == ".npy":
                arr = np.load(p, mmap_mode="r")
                meta.height, meta.width = arr.shape[:2]
            else:
                from PIL import Image
                with Image.open(p) as im:
                    meta.width, meta.height = im.size
        except Exception:
            continue
        out.append(meta)
        if max_images and len(out) >= max_images:
            break
    return out


def scan_folder_quick(folder) -> Dict:
    """Quick folder summary."""
    metas = scan_folder_metadata(folder)
    return {
        "num_images": len(metas),
        "total_bytes": sum(m.file_size for m in metas),
        "names": [m.name for m in metas],
        "dimensions": sorted({(m.width, m.height) for m in metas}),
    }


class ImageCache:
    """FIFO byte-budgeted pixel cache."""

    def __init__(self, max_bytes: int = 2 * 1024 ** 3):
        self.max_bytes = max_bytes
        self._store: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Optional[np.ndarray]:
        if key in self._store:
            self.hits += 1
            return self._store[key]
        self.misses += 1
        return None

    def put(self, key: str, img: np.ndarray) -> None:
        if key in self._store:
            return
        self._store[key] = img
        self._bytes += img.nbytes
        while self._bytes > self.max_bytes and self._store:
            _, old = self._store.popitem(last=False)
            self._bytes -= old.nbytes

    def __contains__(self, key) -> bool:
        return key in self._store

    def __len__(self) -> int:
        return len(self._store)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def stats(self) -> Dict:
        total = self.hits + self.misses
        return {"images": len(self._store), "bytes": self._bytes,
                "hits": self.hits, "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0}

    def clear(self) -> None:
        self._store.clear()
        self._bytes = 0


class BatchImageLoader:
    """Loads only the unique, uncached images of a pair batch."""

    def __init__(self, cache: Optional[ImageCache] = None,
                 resize_to: Optional[Tuple[int, int]] = None):
        self.cache = cache or ImageCache()
        self.resize_to = resize_to

    def load_batch(self, metas: Sequence[ImageMetadata]) -> Dict[str, np.ndarray]:
        out = {}
        misses = [m for m in metas if m.name not in self.cache]
        # fast path: the native C++ pthread-pool decoder (io/native_decoder);
        # any failure there leaves the images to the per-image path
        native = [m for m in misses
                  if Path(m.path).suffix.lower() in (".jpg", ".jpeg", ".png")
                  and m.width > 0 and m.height > 0]
        decoded_now: Dict[str, np.ndarray] = {}
        if len(native) > 1:
            try:
                from tpu3drec_torch.io import native_decoder
                if native_decoder.available():
                    decoded = native_decoder.decode_batch(
                        [m.path for m in native],
                        [(m.height, m.width) for m in native],
                        resize_to=self.resize_to)
                    for m, img in zip(native, decoded):
                        if img is not None:
                            # a natively-decoded image was still a cache
                            # miss — keep hit/miss analytics truthful
                            self.cache.misses += 1
                            self.cache.put(m.name, img)
                            decoded_now[m.name] = img
            except Exception:  # noqa: BLE001 - the PIL path below decodes them
                pass
        for m in metas:
            if m.name in decoded_now:
                # already counted as a miss above; don't route through
                # cache.get, which would record a spurious hit
                out[m.name] = decoded_now.pop(m.name)
                continue
            img = self.cache.get(m.name)
            if img is None:
                img = _read_image(m.path, self.resize_to)
                self.cache.put(m.name, img)
            out[m.name] = img
        return out

    def analyze_batch_reuse(self, prev: Iterable[str],
                            nxt: Iterable[str]) -> Dict:
        """Cache-reuse analytics between consecutive batches."""
        prev, nxt = set(prev), set(nxt)
        reused = prev & nxt
        return {"reused": len(reused), "new": len(nxt - prev),
                "dropped": len(prev - nxt),
                "reuse_ratio": len(reused) / len(nxt) if nxt else 0.0}


class FolderImageSource:
    """Folder-backed image source."""

    def __init__(self, folder, resize_to: Optional[Tuple[int, int]] = None,
                 max_images: Optional[int] = None,
                 cache_bytes: int = 2 * 1024 ** 3):
        self.folder = str(folder)
        self.metadata = scan_folder_metadata(folder, max_images)
        self.loader = BatchImageLoader(ImageCache(cache_bytes), resize_to)

    def get_metadata_list(self) -> List[ImageMetadata]:
        return self.metadata

    def names(self) -> List[str]:
        return [m.name for m in self.metadata]

    def load(self, name: str) -> np.ndarray:
        meta = next(m for m in self.metadata if m.name == name)
        return self.loader.load_batch([meta])[name]

    def load_many(self, names: Sequence[str]) -> Dict[str, np.ndarray]:
        lookup = {m.name: m for m in self.metadata}
        return self.loader.load_batch([lookup[n] for n in names])


def create_pairs_from_metadata(metas: Sequence[ImageMetadata],
                               mode: str = "consecutive",
                               window: int = 1) -> List[Tuple[str, str]]:
    """Pair-generation modes: 'consecutive' (i, i+1..i+window), 'first'
    (0, i), 'all' (i < j)."""
    names = [m.name for m in metas]
    n = len(names)
    pairs: List[Tuple[str, str]] = []
    if mode == "consecutive":
        for i in range(n):
            for k in range(1, window + 1):
                if i + k < n:
                    pairs.append((names[i], names[i + k]))
    elif mode == "first":
        pairs = [(names[0], names[i]) for i in range(1, n)]
    elif mode == "all":
        pairs = [(names[i], names[j]) for i in range(n) for j in range(i + 1, n)]
    else:
        raise ValueError(f"unknown pair mode {mode!r}")
    return pairs
