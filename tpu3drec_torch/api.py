"""Public API for the ported methods: `prepare_image`, `detect_features`,
`match_images`, `quick_match` (SIFT only in this slice).

Port of the matching half of `tpu3drec/api.py`. These entry points take
host images and a `device` (None means CUDA; see `core.device`).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from tpu3drec_torch.core.config import (
    DETECTOR_SPECIFIC_CONFIGS, MATCHER_SPECIFIC_CONFIGS,
)
from tpu3drec_torch.core.device import resolve_device
from tpu3drec_torch.core.types import Features, MethodResult
from tpu3drec_torch.ops import image as imops
from tpu3drec_torch.ops.geometry import (
    find_homography, reprojection_error_homography,
)
from tpu3drec_torch.ops.match import auto_select_matcher, match_features
from tpu3drec_torch.ops.sift import detect_sift_features


# name -> detect fn (image (H, W) float32 tensor, **params) -> Features
_DETECTORS = {"SIFT": detect_sift_features}


def prepare_image(image, device=None) -> torch.Tensor:
    """Any uint8/float, gray/RGB image -> (H, W) float32 tensor in [0, 1]."""
    dev = resolve_device(device)
    arr = np.asarray(image)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    else:
        arr = arr.astype(np.float32)
        if arr.max() > 2.0:  # heuristically 0-255 floats
            arr = arr / 255.0
    return imops.rgb_to_gray(torch.from_numpy(arr).to(dev))


def _detector_params(method: str, config: Optional[Dict[str, Any]],
                     max_features: Optional[int]) -> Dict[str, Any]:
    params = dict(DETECTOR_SPECIFIC_CONFIGS.get(method, {}))
    if config:
        params.update((config.get("detector_params") or {}).get(method, {}))
        if config.get("max_features"):
            params["max_features"] = config["max_features"]
    if max_features:
        params["max_features"] = max_features
    return params


def detect_features(image, method: str = "SIFT",
                    max_features: Optional[int] = None,
                    config: Optional[Dict[str, Any]] = None,
                    device=None, **params) -> Features:
    """Detect keypoints + descriptors with one method."""
    if method not in _DETECTORS:
        raise ValueError(f"Unknown or unavailable detector {method!r}; "
                         f"have {sorted(_DETECTORS)}")
    img = prepare_image(image, device)
    kw = _detector_params(method, config, max_features)
    kw.update(params)
    return _DETECTORS[method](img, **kw)


def match_images(image1, image2, method: str = "SIFT",
                 matcher: str = "auto", ratio: Optional[float] = None,
                 max_features: Optional[int] = None,
                 filter_matches: bool = True,
                 ransac_threshold: float = 4.0,
                 config: Optional[Dict[str, Any]] = None,
                 device=None) -> MethodResult:
    """Detect + match + homography-filter one pair with one method:
    raw matches, RANSAC-filtered matches, homography, inlier ratio and
    reprojection error."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    f1 = detect_features(image1, method, max_features, config, device=dev)
    f2 = detect_features(image2, method, max_features, config, device=dev)
    float(f1.desc.sum() + f2.desc.sum())         # wait for the device
    t1 = time.perf_counter()

    if matcher == "auto":
        matcher = auto_select_matcher(f1)
    mparams = dict(MATCHER_SPECIFIC_CONFIGS.get(matcher, {}))
    if ratio is not None:
        mparams["ratio_threshold"] = ratio
    m = match_features(f1, f2, ratio=mparams.get("ratio_threshold", 0.75),
                       cross_check=mparams.get("cross_check", False),
                       method=method)
    int(m.mask.sum())
    t2 = time.perf_counter()

    result = MethodResult(method=method, features1=f1, features2=f2,
                          matches=m, detection_time=t1 - t0,
                          matching_time=t2 - t1, matcher_used=matcher)
    if filter_matches:
        p1, p2 = m.gather_points(f1, f2)
        gen = torch.Generator(device=dev).manual_seed(0)
        rr = find_homography(p1, p2, mask=m.mask, threshold=ransac_threshold,
                             generator=gen)
        if bool(rr.success):
            result.filtered_matches = m.replace(mask=rr.inliers)
            result.homography = rr.model.cpu().numpy()
            result.inlier_ratio = float(rr.inlier_ratio)
            result.reprojection_error = float(
                reprojection_error_homography(rr.model, p1, p2, rr.inliers))
    return result


def quick_match(image1, image2, method: str = "SIFT", **kw) -> MethodResult:
    """One-call pair matching."""
    return match_images(image1, image2, method=method, **kw)
