"""Inter-stage pickle format: the contract between the matching stage and
the SfM stage.

Port of `tpu3drec/io/batch_pickle.py`: the writer (`pair_data_from_result`,
`save_batch`, `save_image_metadata`), the loader
(`load_and_validate_pickle`) and the stage glue (`load_images`, the
keypoint dict converters). The schema is the reference's:

  <base>_batch_NNN.pkl : {results: {(img1, img2): pair_data},
                          batch_stats, overall_progress, config}
  <base>_image_metadata.pkl : {images: [{name, width, height, ...}]}

pair_data = {correspondences: Nx4 [x1, y1, x2, y2], num_matches,
             quality_score, method, score_type, processing_time, ...}

The pickles hold plain dicts, lists and numpy arrays, so either package's
matching output feeds either package's SfM stage. Unpickle only files
that a matching stage of this project wrote: unpickling can run code.
"""

from __future__ import annotations

import ast
import glob
import pickle
import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

PairKey = Tuple[str, str]


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def pair_data_from_result(result, max_matches: Optional[int] = None) -> Dict:
    """MethodResult -> reference pair_data dict (Nx4 correspondences)."""
    m = result.best_matches
    p1 = _host(result.features1.xy)[_host(m.idx1)]
    p2 = _host(result.features2.xy)[_host(m.idx2)]
    valid = _host(m.mask)
    corr = np.concatenate([p1[valid], p2[valid]], axis=1)
    if max_matches:
        corr = corr[:max_matches]
    scores = _host(m.score)[valid]
    if max_matches:
        scores = scores[:max_matches]
    return {
        "correspondences": corr.tolist(),
        "num_matches": len(corr),
        "quality_score": float(result.get_quality_score()),
        "method": result.method,
        "score_type": m.score_type,
        # raw per-match scores for score-type-aware confidence
        # normalization downstream
        "match_scores": scores.tolist(),
        "processing_time": float(result.total_time),
        "inlier_ratio": result.inlier_ratio,
        "reprojection_error": result.reprojection_error,
    }


def save_batch(output_dir, base: str, batch_number: int,
               results: Dict[PairKey, Dict],
               config: Optional[Dict] = None,
               progress: Optional[Dict] = None) -> Path:
    """Write one <base>_batch_NNN.pkl in the reference schema."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{base}_batch_{batch_number:03d}.pkl"
    payload = {
        "results": results,
        "batch_stats": {
            "batch_number": batch_number,
            "pairs_in_batch": len(results),
            "batch_processing_time": sum(
                r.get("processing_time", 0.0) for r in results.values()),
            "timestamp": time.time(),
        },
        "overall_progress": progress or {},
        "config": config or {},
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return path


def save_image_metadata(output_dir, base: str,
                        metas: Sequence) -> Path:
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{base}_image_metadata.pkl"
    images = [m.to_dict() if hasattr(m, "to_dict") else dict(m) for m in metas]
    with open(path, "wb") as f:
        pickle.dump({"images": images}, f)
    return path


def load_and_validate_pickle(pickle_file: str) -> Dict:
    """Load and merge batch pickles.

    Accepts a single batch file (its siblings `<base>_batch_*` are merged
    too), a glob pattern, or any other pickle of the same layout; returns
    {image_names, image_info, matches_data, processing_stats,
    feature_type, total_images, batch_info}.
    """
    pickle_file = str(pickle_file)
    if "*" in pickle_file:
        batch_files = sorted(glob.glob(pickle_file))
        dir_path = Path(pickle_file).parent
        m = re.match(r"(.+?)_batch_\*(\.\w+)$", Path(pickle_file).name)
        base = m.group(1) if m else None
    else:
        p = Path(pickle_file)
        if not p.exists():
            raise FileNotFoundError(pickle_file)
        dir_path = p.parent
        m = re.match(r"(.+?)_batch_\d+(\.\w+)$", p.name)
        if m:
            base = m.group(1)
            batch_files = sorted(glob.glob(str(dir_path / f"{base}_batch_*{m.group(2)}")))
        else:
            base = None
            batch_files = [pickle_file]
    if not batch_files:
        raise FileNotFoundError(f"no batch files for {pickle_file}")

    matches_data: Dict[PairKey, Dict] = {}
    image_names = set()
    stats = {"total_pairs": 0, "successful_pairs": 0, "failed_pairs": 0,
             "total_matches": 0, "quality_scores": []}
    feature_type = "Unknown"
    for bf in batch_files:
        with open(bf, "rb") as f:
            data = pickle.load(f)
        results = data.get("results", {})
        cfg = data.get("config") or {}
        if feature_type == "Unknown":
            feature_type = cfg.get("feature_type", cfg.get("method", "Unknown"))
        for key, pd in results.items():
            if isinstance(key, str) and key.startswith("("):
                try:
                    # string keys "('a', 'b')": literal_eval only, a
                    # pickle key must never execute code
                    key = ast.literal_eval(key)
                except (ValueError, SyntaxError):
                    continue
            if not (isinstance(key, tuple) and len(key) == 2):
                continue
            if key in matches_data:
                continue
            image_names.update(key)
            matches_data[key] = pd
            stats["total_pairs"] += 1
            if "error" in pd:
                stats["failed_pairs"] += 1
            else:
                stats["successful_pairs"] += 1
                stats["total_matches"] += pd.get("num_matches", 0)
                if "quality_score" in pd:
                    stats["quality_scores"].append(pd["quality_score"])

    image_info: Dict[str, Dict] = {}
    if base:
        meta_path = dir_path / f"{base}_image_metadata.pkl"
        if meta_path.exists():
            with open(meta_path, "rb") as f:
                md = pickle.load(f)
            lookup = {im["name"]: im for im in md.get("images", [])}
            for n in sorted(image_names):
                image_info[n] = dict(lookup.get(n, {"name": n}))
    for n in sorted(image_names):
        image_info.setdefault(n, {"name": n})

    # every pair's correspondences are N x 4
    for key, pd in matches_data.items():
        corr = pd.get("correspondences")
        if corr is not None and len(corr) > 0 and len(corr[0]) != 4:
            raise ValueError(f"invalid correspondences for pair {key}")

    return {
        "image_names": sorted(image_names),
        "image_info": image_info,
        "matches_data": matches_data,
        "processing_stats": stats,
        "feature_type": feature_type,
        "total_images": len(image_names),
        "batch_info": {"files": [str(b) for b in batch_files]},
    }


def load_images(image_paths: Sequence[str]) -> List[Tuple[np.ndarray, str]]:
    """(image, filename) tuples for each decodable path, skipping failures
    with a warning. Images are float32 grayscale [0,1], the detectors'
    contract."""
    from tpu3drec_torch.io.images import _read_image
    out: List[Tuple[np.ndarray, str]] = []
    for path in image_paths:
        try:
            img = _read_image(str(path))
        except Exception as e:  # noqa: BLE001 - an unreadable file is skipped
            print(f"Warning: Could not load image {path}: {e}")
            continue
        out.append((img, Path(path).name))
    return out


def keypoints_to_serializable(features) -> List[Dict]:
    """Features -> list of cv2.KeyPoint-style dicts (valid rows only):
    `angle` in DEGREES in [0, 360), `size` a diameter."""
    f = features.to_numpy() if hasattr(features, "to_numpy") else features
    xy, size = np.asarray(f["xy"]), np.asarray(f["scale"])
    ang, resp = np.asarray(f["angle"]), np.asarray(f["response"])
    ang_deg = np.degrees(ang) % 360.0
    return [{"pt": (float(xy[i, 0]), float(xy[i, 1])), "size": float(size[i]),
             "angle": float(ang_deg[i]), "response": float(resp[i])}
            for i in range(len(xy))]


def serializable_to_keypoints(serializable_kps: Sequence[Dict],
                              desc=None, image_shape=(), device=None):
    """Inverse of keypoints_to_serializable: degrees -> radians wrapped to
    (-pi, pi]; a Features on `device` (None means CUDA)."""
    from tpu3drec_torch.core.types import Features
    items = list(serializable_kps)
    xy = np.asarray([d["pt"] for d in items], np.float32).reshape(-1, 2)
    deg = np.asarray([d.get("angle", 0.0) for d in items], np.float32)
    rad = np.radians(deg)
    rad = (rad + np.pi) % (2 * np.pi) - np.pi
    return Features.from_numpy(
        xy, desc if desc is not None else np.zeros((len(xy), 0)),
        response=[d.get("response", 0.0) for d in items],
        scale=[d.get("size", 1.0) for d in items],
        angle=rad, image_shape=image_shape, device=device)
