"""Multi-method match merging with index-offset bookkeeping.

Port of `tpu3drec/core/multi_match.py` (host numpy): when
`combine_strategy` is 'weighted', matches from several detector methods
are merged into one correspondence set over a CONCATENATED keypoint space —
each method's keypoint indices are shifted by the cumulative capacity of
the methods before it, scores are normalized per method (distance vs
confidence algebra), and near-duplicate correspondences across methods
are collapsed. Results may hold their tensors on any device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from tpu3drec_torch.core.types import Features, MethodResult


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def concat_features(features: Sequence[Features]) -> Tuple[np.ndarray, List[int]]:
    """Concatenate keypoint coordinate arrays; returns (xy_all, offsets).

    offsets[i] is the index shift applied to method i's keypoint indices
    in the merged space.
    """
    offsets: List[int] = []
    xs = []
    total = 0
    for f in features:
        offsets.append(total)
        xs.append(_host(f.xy))
        total += f.capacity
    return np.concatenate(xs, axis=0), offsets


def merge_method_matches(results: Dict[str, MethodResult],
                         use_filtered: bool = True,
                         dedup_px: float = 1.5) -> Dict:
    """Merge per-method matches into one offset-indexed correspondence set.

    Returns {xy1_all, xy2_all, idx1, idx2, quality, method_of, offsets,
    methods}: indices address the concatenated keypoint arrays; `quality`
    is the per-match normalized quality (higher better) so mixed
    DISTANCE/CONFIDENCE methods compare fairly; near-duplicates (both
    endpoints within dedup_px across methods) keep the highest-quality copy.
    """
    methods = list(results)
    feats1 = [results[m].features1 for m in methods]
    feats2 = [results[m].features2 for m in methods]
    xy1_all, off1 = concat_features(feats1)
    xy2_all, off2 = concat_features(feats2)

    idx1, idx2, quality, method_of = [], [], [], []
    p1_list, p2_list = [], []
    for mi, m in enumerate(methods):
        r = results[m]
        matches = r.best_matches if use_filtered else r.matches
        got = matches.to_numpy()
        if len(got["idx1"]) == 0:
            continue
        q = _host(matches.quality())[_host(matches.mask)]
        # weight by the method's overall quality score (the 'weighted'
        # combine strategy)
        q = q * (0.5 + 0.5 * r.get_quality_score())
        idx1.append(got["idx1"] + off1[mi])
        idx2.append(got["idx2"] + off2[mi])
        quality.append(q)
        method_of.append(np.full(len(got["idx1"]), mi, np.int32))
        p1_list.append(_host(feats1[mi].xy)[got["idx1"]])
        p2_list.append(_host(feats2[mi].xy)[got["idx2"]])

    if not idx1:
        return {"xy1_all": xy1_all, "xy2_all": xy2_all,
                "idx1": np.zeros(0, int), "idx2": np.zeros(0, int),
                "quality": np.zeros(0), "method_of": np.zeros(0, int),
                "offsets": (off1, off2), "methods": methods}

    idx1 = np.concatenate(idx1)
    idx2 = np.concatenate(idx2)
    quality = np.concatenate(quality)
    method_of = np.concatenate(method_of)
    p1 = np.concatenate(p1_list)
    p2 = np.concatenate(p2_list)

    # cross-method dedup: bucket both endpoints to a dedup_px grid and keep
    # the best-quality representative per bucket
    key1 = np.round(p1 / dedup_px).astype(np.int64)
    key2 = np.round(p2 / dedup_px).astype(np.int64)
    bucket = (key1[:, 0] << 48) ^ (key1[:, 1] << 32) \
        ^ (key2[:, 0] << 16) ^ key2[:, 1]
    order = np.lexsort((-quality, bucket))
    bucket_sorted = bucket[order]
    first = np.ones(len(order), bool)
    first[1:] = bucket_sorted[1:] != bucket_sorted[:-1]
    keep = order[first]
    keep.sort()

    return {
        "xy1_all": xy1_all, "xy2_all": xy2_all,
        "idx1": idx1[keep], "idx2": idx2[keep],
        "quality": quality[keep], "method_of": method_of[keep],
        "correspondences": np.concatenate([p1[keep], p2[keep]], axis=1),
        "offsets": (off1, off2), "methods": methods,
        "per_method_counts": {m: int((method_of[keep] == i).sum())
                              for i, m in enumerate(methods)},
    }
