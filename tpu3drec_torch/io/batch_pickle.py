"""Inter-stage pickle format: the contract between the matching stage and
the SfM stage, loader half.

Port of `tpu3drec/io/batch_pickle.py:load_and_validate_pickle`. The
schema is the reference's:

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
from pathlib import Path
from typing import Dict, Tuple

PairKey = Tuple[str, str]


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
