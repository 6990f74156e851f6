"""Dataset acquisition: Pixabay image downloader and an offline
synthetic stand-in.

Port of `tpu3drec/data/downloader.py`. `download_pixabay_images` queries
the Pixabay API for photos and saves `target_count` images into
`output_dir`, with pagination, dedup by image id and rate limiting; it
needs an API key and network access, and raises the reference's errors
without them. `generate_synthetic_dataset` writes a seeded multi-view
synthetic folder for the matching and SfM pipelines: 8-bit grayscale
PNGs, through PIL where it imports and otherwise through a standard
library writer (`write_png_gray`), whose files PIL and the native decoder
read back exactly.
"""

from __future__ import annotations

import json
import struct
import time
import urllib.parse
import zlib
import urllib.request
from pathlib import Path
from typing import Dict, List, Optional

PIXABAY_URL = "https://pixabay.com/api/"


def download_pixabay_images(output_dir, query: str = "statue of liberty",
                            target_count: int = 50,
                            api_key: Optional[str] = None,
                            per_page: int = 50,
                            delay_s: float = 0.3) -> Dict:
    """Download `target_count` photos for `query`. Requires network
    access and an API key."""
    if not api_key:
        raise ValueError("Pixabay API key required (reference reads it "
                         "from the environment)")
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    seen: set = set()
    saved: List[str] = []
    page = 1
    while len(saved) < target_count:
        params = urllib.parse.urlencode({
            "key": api_key, "q": query, "image_type": "photo",
            "per_page": per_page, "page": page,
        })
        try:
            with urllib.request.urlopen(f"{PIXABAY_URL}?{params}",
                                        timeout=20) as r:
                data = json.loads(r.read())
        except OSError as e:
            raise RuntimeError(
                f"network unreachable (zero-egress environment?): {e}"
            ) from e
        hits = data.get("hits", [])
        if not hits:
            break
        for h in hits:
            if h["id"] in seen:
                continue
            seen.add(h["id"])
            url = h.get("largeImageURL") or h.get("webformatURL")
            name = f"pixabay_{h['id']}.jpg"
            try:
                with urllib.request.urlopen(url, timeout=30) as img:
                    (out / name).write_bytes(img.read())
                saved.append(name)
            except OSError:
                continue
            if len(saved) >= target_count:
                break
            time.sleep(delay_s)
        page += 1
    return {"downloaded": len(saved), "files": saved,
            "output_dir": str(out)}


def write_png_gray(path, img_u8) -> None:
    """(H, W) uint8 array -> an 8-bit grayscale PNG (standard library)."""
    import numpy as np
    a = np.ascontiguousarray(img_u8, np.uint8)
    h, w = a.shape
    # filter type 0 (none) before each row
    raw = np.concatenate([np.zeros((h, 1), np.uint8), a], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                           + chunk(b"IDAT", zlib.compress(raw, 6))
                           + chunk(b"IEND", b""))


def _save_gray(path, img_u8) -> None:
    try:
        from PIL import Image
    except ImportError:
        write_png_gray(path, img_u8)
        return
    Image.fromarray(img_u8).save(path)


def generate_synthetic_dataset(output_dir, n_views: int = 10,
                               width: int = 640, height: int = 480,
                               seed: int = 42) -> Dict:
    """Offline stand-in: a seeded synthetic 'monument' rendered from a
    slowly rotating viewpoint (overlapping views with real parallax-like
    drift, suitable for the matching + SfM pipelines)."""
    import numpy as np
    from tpu3drec_torch.bench.synthetic import SyntheticImageGenerator, _warp

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    gen = SyntheticImageGenerator(width=int(width * 1.4),
                                  height=int(height * 1.4), seed=seed)
    base = gen.generate()
    files = []
    cx, cy = base.shape[1] / 2, base.shape[0] / 2
    for i in range(n_views):
        a = (i - n_views / 2) * 0.03
        s = 1.0 + 0.01 * (i - n_views / 2)
        H = np.array([[s * np.cos(a), -s * np.sin(a),
                       cx * (1 - s * np.cos(a)) + cy * s * np.sin(a) + 6 * i],
                      [s * np.sin(a), s * np.cos(a),
                       cy * (1 - s * np.cos(a)) - cx * s * np.sin(a)],
                      [0, 0, 1.0]])
        view = _warp(base, H)
        crop = view[:height, :width]
        name = f"synthetic_{i:03d}.png"
        _save_gray(out / name, (np.clip(crop, 0, 1) * 255).astype(np.uint8))
        files.append(name)
    return {"generated": len(files), "files": files, "output_dir": str(out)}
