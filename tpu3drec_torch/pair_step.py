"""The flagship pair step: SIFT on both images -> int8 2-NN ratio match ->
4-point homography RANSAC, for a batch of image pairs.

Port of `__graft_entry__.py:_make_pair_fn`, which the reference's
`bench.py` batches with vmap. Here the batch is explicit: all 2B images
go through SIFT as one batch (the `ori_desc` kernel launches once per
octave), all B pairs are matched by one `knn2` launch, and RANSAC scores
every pair's hypotheses at once.

While a profiler records, the three stages run under the spans
`pair_step.detect`, `pair_step.match` and `pair_step.ransac`
(`utils/profiling.py:span`). Inside detection, each octave opens
`sift.blur`, `sift.extrema`, `sift.refine`, `sift.ori_desc` and
`sift.select` (`ops/sift.py`); inside matching, `knn2.kernel` holds the
kernel's launch alone (`ops/pallas_match.py:knn2_raw`). The counters
`knn2.macs.*`, `knn2.bytes`, `upload.copies` and `upload.bytes` count
the kernel's work and the host constants copied to the device.

`make_deep_pair_fn` is the deep pair step beside it: SuperPoint on all
2B images, LightGlue on all B pairs in one forward, the mutual,
confidence-gated matches, and the same RANSAC stage, under the same
three spans (inside them the models' `superpoint.*` and `lightglue.*`
spans; `models/superpoint.py`, `models/lightglue.py`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from tpu3drec_torch.models.lightglue import (
    assignment_matches, normalize_keypoints,
)
from tpu3drec_torch.ops.geometry import find_homography
from tpu3drec_torch.ops.match import knn2
from tpu3drec_torch.ops.ransac import draw_uniform
from tpu3drec_torch.ops.sift import detect_and_compute
from tpu3drec_torch.utils.profiling import span

RATIO = 0.75


def _check_pair(img1: torch.Tensor, img2: torch.Tensor) -> None:
    if img1.shape != img2.shape or img1.ndim != 3:
        raise ValueError(f"pair_fn: need two (B, H, W) batches of one "
                         f"shape, got {tuple(img1.shape)} and "
                         f"{tuple(img2.shape)}")


def ransac_stage(xy1: torch.Tensor, p2: torch.Tensor, ok: torch.Tensor,
                 num_hypotheses: int, u: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """Both steps' last stage, under `pair_step.ransac`: 4-point homography
    RANSAC (4 px) of the matches xy1 (B, N, 2) -> p2 (B, N, 2) where `ok`
    (B, N). Every pair uses the same (K, 4) uniforms, drawn from a
    generator seeded with 0 on the points' device (the reference uses one
    fixed key for every pair too); `u` injects them. Returns
    num_matches (B,), num_inliers (B,), inlier_ratio (B,) and homography
    (B, 3, 3)."""
    with span("pair_step.ransac"):
        if u is None:
            gen = torch.Generator(device=xy1.device).manual_seed(0)
            u = draw_uniform(num_hypotheses, 4, gen, xy1.device)
        rr = find_homography(xy1, p2, mask=ok, num_hypotheses=num_hypotheses,
                             refit=False, u=u)
    return {
        "num_matches": ok.sum(-1, dtype=torch.int32),
        "num_inliers": rr.num_inliers,
        "inlier_ratio": rr.inlier_ratio,
        "homography": rr.model,
    }


def deep_ransac(xy: torch.Tensor, best1: torch.Tensor, ok: torch.Tensor,
                num_hypotheses: int, u: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """The deep step's RANSAC: the first views' keypoints of `xy` (2B, N,
    2; first views, then second views) matched to the second views'
    keypoints at `best1` (B, N) where `ok` (B, N), through
    `ransac_stage`."""
    B = best1.shape[0]
    p2 = xy[B:].gather(1, best1.long()[..., None].expand(-1, -1, 2))
    return ransac_stage(xy[:B], p2, ok, num_hypotheses, u)


def make_pair_fn(max_features: int = 512, num_hypotheses: int = 128
                 ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns `pair_fn(img1, img2, u=None)` over (B, H, W) float32 image
    tensors in [0, 1], on their device, with `ransac_stage`'s answers
    (`u` injects its uniforms)."""

    def pair_fn(img1: torch.Tensor, img2: torch.Tensor,
                u: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        _check_pair(img1, img2)
        B = img1.shape[0]
        with span("pair_step.detect"):
            xy, _, _, _, desc, mask = detect_and_compute(
                torch.cat([img1, img2]), max_features)
        xy1, xy2 = xy[:B], xy[B:]
        m1, m2 = mask[:B], mask[B:]
        with span("pair_step.match"):
            nn_idx, nn_dist = knn2(desc[:B], desc[B:], m1, m2, metric="l2_int8")
            ok = (nn_dist[..., 0] < RATIO * torch.clamp(nn_dist[..., 1], min=1e-12)) & m1
            p2 = xy2.gather(1, nn_idx[..., :1].long().expand(-1, -1, 2))
        return ransac_stage(xy1, p2, ok, num_hypotheses, u)

    return pair_fn


def make_deep_pair_fn(superpoint, lightglue, num_hypotheses: int = 256,
                      filter_threshold: float = 0.1
                      ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns `pair_fn(img1, img2, u=None)` over (B, H, W) float32 image
    tensors in [0, 1]: SuperPoint + LightGlue + 4-point homography RANSAC.

    `superpoint` and `lightglue` are the wrappers of `models/`
    (`SuperPoint`, `LightGlue`) with their networks on the images' device,
    built by `init_random`, from a state dict or from converted weights;
    they carry the keypoint budget, NMS radius, detection threshold,
    precision and activation type. Keypoints are normalised by the images' own (H, W).
    Matches are LightGlue's mutual argmax above `filter_threshold`, then
    `deep_ransac`.

    Returns `make_pair_fn`'s num_matches, num_inliers, inlier_ratio and
    homography, and, as device tensors for a check of the networks:
    keypoints (2B, N, 2), scores (2B, N), descriptors (2B, N, D) and
    keypoint_mask (2B, N) of every image (first views, then second views);
    the log-assignment's row and column maxima assign_row_max,
    assign_col_max (B, N); the matchability logits z0, z1 (B, N); each
    first-view keypoint's argmax in the second view best1 (B, N) and
    whether the two are each other's argmax between valid keypoints,
    mutual (B, N), both before the confidence gate."""

    @torch.no_grad()
    def pair_fn(img1: torch.Tensor, img2: torch.Tensor,
                u: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        _check_pair(img1, img2)
        B, h, w = img1.shape
        with span("pair_step.detect"):
            f = superpoint.extract(torch.cat([img1, img2]))
        xy, mask = f.xy, f.mask
        m1, m2 = mask[:B], mask[B:]
        with span("pair_step.match"):
            xyn = normalize_keypoints(xy, h, w)
            log_assign, _, z0, z1 = lightglue.forward(
                f.desc[:B], f.desc[B:], xyn[:B], xyn[B:], m1, m2)
            with span("lightglue.assign"):
                # every mutual pair first, the confidence gate after
                m = assignment_matches(log_assign, m1, m2, -1.0)
                ok = m.mask & (m.score > filter_threshold)
                row_max = log_assign.amax(2)
                col_max = log_assign.amax(1)
        out = deep_ransac(xy, m.idx2, ok, num_hypotheses, u)
        out.update(keypoints=xy, scores=f.response, descriptors=f.desc,
                   keypoint_mask=mask, assign_row_max=row_max,
                   assign_col_max=col_max, z0=z0, z1=z1, best1=m.idx2,
                   mutual=m.mask)
        return out

    return pair_fn
