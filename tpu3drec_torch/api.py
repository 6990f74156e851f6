"""Public API: detection, pair matching, folder matching and the folder
chain from images to a sparse and a dense reconstruction.

Port of `tpu3drec/api.py`: `prepare_image`, `detect_features`,
`match_images`, `quick_match`, `create_pipeline`, `quick_process_folder`
and `reconstruct_folder`. These entry points take host images or a
folder and a `device` (None means CUDA; see `core.device`).

The detector registry holds every detector of the reference that needs
no weights: SIFT, Harris, GoodFeatures (alias GFTT), ORB, AKAZE and BRISK.
Each takes one `(H, W)` image or a `(B, H, W)` batch and runs on the
tensor's device. The deep detectors follow the reference's rule: without
converted weights on disk they are unavailable (not registered), and with
weights present they raise `NotImplementedError` naming ROADMAP Queue 1
#6, which ports them.
"""

from __future__ import annotations

import time
from pathlib import Path
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
from tpu3drec_torch.ops.akaze import detect_akaze_features
from tpu3drec_torch.ops.brisk import detect_brisk_features
from tpu3drec_torch.ops.harris import detect_harris_features
from tpu3drec_torch.ops.match import auto_select_matcher, match_features
from tpu3drec_torch.ops.orb import detect_orb_features
from tpu3drec_torch.ops.sift import detect_sift_features
from tpu3drec_torch.pipelines.matching import create_pipeline


def _harris(img, **kw):
    kw.pop("use_harris", None)
    return detect_harris_features(img, use_harris=True, method="Harris", **kw)


def _gftt(img, **kw):
    kw.pop("use_harris", None)
    return detect_harris_features(img, use_harris=False,
                                  method="GoodFeatures", **kw)


# name -> detect fn ((H, W) or (B, H, W) float32 tensor, **params) -> Features
_DETECTORS = {
    "SIFT": detect_sift_features,
    "Harris": _harris,
    "GoodFeatures": _gftt,
    "GFTT": _gftt,          # the reference's alias
    "ORB": detect_orb_features,
    "AKAZE": detect_akaze_features,
    "BRISK": detect_brisk_features,
}
# deep detector -> its weights file stem
_DEEP = {"SuperPoint": "superpoint", "DISK": "disk", "ALIKED": "aliked"}


def _get_detector_registry() -> Dict[str, Any]:
    """Name -> detect fn of the detectors the port runs."""
    return dict(_DETECTORS)


def check_detector(method: str) -> None:
    """Raise `NotImplementedError` for a deep detector whose converted
    weights are on disk (the port does not run the deep models yet);
    return for any other name."""
    if method in _DEEP:
        from tpu3drec_torch.models import weights_available
        if weights_available(_DEEP[method]):
            raise NotImplementedError(
                f"tpu3drec_torch: converted {method} weights are on disk, "
                f"but the deep detectors are not ported yet (ROADMAP "
                f"Queue 1 #6)")


def unit_float(image) -> np.ndarray:
    """Any uint8/float image -> float32 numpy in [0, 1] (0-255 floats are
    recognised by a maximum above 2)."""
    arr = np.asarray(image)
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    arr = arr.astype(np.float32)
    if arr.max() > 2.0:  # heuristically 0-255 floats
        arr = arr / 255.0
    return arr


def prepare_image(image, device=None) -> torch.Tensor:
    """Any uint8/float, gray/RGB image -> (H, W) float32 tensor in [0, 1]."""
    dev = resolve_device(device)
    return imops.rgb_to_gray(torch.from_numpy(unit_float(image)).to(dev))


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
    check_detector(method)
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


def quick_process_folder(folder, output_dir, preset: str = "balanced",
                         device=None, **kw):
    """One-call folder matching: `create_pipeline(preset).match_folder`."""
    return create_pipeline(preset, device=device).match_folder(
        folder, output_dir, **kw)


def reconstruct_folder(folder, output_dir, preset: str = "balanced",
                       dense: bool = False,
                       sfm_config=None,
                       chosen_images: Optional[list] = None,
                       device=None,
                       **match_kw) -> Dict[str, Any]:
    """End-to-end chain on `device`: folder matching -> incremental SfM
    [-> dense], each stage's output handed to the next in memory (the
    batch pickles and the SfM exports are written as well).

    Homography filtering is off for the chain: it prunes valid
    correspondences of 3-D scenes, and SfM runs its own essential-matrix
    RANSAC. `timings_s` holds each stage's host seconds."""
    from tpu3drec_torch.io.images import FolderImageSource
    from tpu3drec_torch.pipelines.dense import run_dense_reconstruction
    from tpu3drec_torch.sfm import SfMPipeline

    dev = resolve_device(device)
    out = Path(output_dir)
    timings: Dict[str, float] = {}
    t0 = time.perf_counter()
    pipe = create_pipeline(preset, {
        "filtering": {"use_adaptive_filtering": False}}, device=dev)
    summary = pipe.match_folder(folder, out / "matching",
                                collect_results=True, **match_kw)
    matches_data = summary.pop("matches_data")
    image_info = summary.pop("image_info")
    timings["matching"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    sfm = SfMPipeline(sfm_config, device=dev)
    recon = sfm.reconstruct(matches_data, image_info,
                            output_dir=out / "sfm",
                            chosen_images=chosen_images,
                            checkpoint_dir=out / "sfm")
    timings["sfm"] = time.perf_counter() - t0
    result: Dict[str, Any] = {
        "matching": summary,
        "reconstruction": recon,
        "sfm_stats": recon.stats(),
        "timings_s": timings,
    }
    if dense and recon.num_cameras >= 2:
        t0 = time.perf_counter()
        src = FolderImageSource(folder)
        names = set(recon.cameras)
        images = src.loader.load_batch(
            [m for m in src.get_metadata_list() if m.name in names])
        result["dense"] = run_dense_reconstruction(
            recon.to_legacy_format(), images, output_dir=out / "dense",
            device=dev)
        timings["dense"] = time.perf_counter() - t0
    return result
