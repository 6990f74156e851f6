"""The flagship pair step: SIFT on both images -> int8 2-NN ratio match ->
4-point homography RANSAC, for a batch of image pairs.

Port of `__graft_entry__.py:_make_pair_fn`, which the reference's
`bench.py` batches with vmap. Here the batch is explicit: all 2B images
go through SIFT as one batch (the `ori_desc` kernel launches once per
octave), all B pairs are matched by one `knn2` launch, and RANSAC scores
every pair's hypotheses at once. The three stages run under profiler
ranges `pair_step.detect`, `pair_step.match` and `pair_step.ransac`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.profiler import record_function

from tpu3drec_torch.ops.geometry import find_homography
from tpu3drec_torch.ops.match import knn2
from tpu3drec_torch.ops.ransac import draw_uniform
from tpu3drec_torch.ops.sift import detect_and_compute

RATIO = 0.75


def make_pair_fn(max_features: int = 512, num_hypotheses: int = 128
                 ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns `pair_fn(img1, img2, u=None)` over (B, H, W) float32 image
    tensors in [0, 1], on their device. Every pair uses the same (K, 4)
    RANSAC uniforms, drawn from a generator seeded with 0 (the reference
    uses one fixed key for every pair too); `u` injects them.
    Returns num_matches (B,), num_inliers (B,), inlier_ratio (B,) and
    homography (B, 3, 3)."""

    def pair_fn(img1: torch.Tensor, img2: torch.Tensor,
                u: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if img1.shape != img2.shape or img1.ndim != 3:
            raise ValueError(f"pair_fn: need two (B, H, W) batches of one "
                             f"shape, got {tuple(img1.shape)} and "
                             f"{tuple(img2.shape)}")
        B = img1.shape[0]
        with record_function("pair_step.detect"):
            xy, _, _, _, desc, mask = detect_and_compute(
                torch.cat([img1, img2]), max_features)
        xy1, xy2 = xy[:B], xy[B:]
        m1, m2 = mask[:B], mask[B:]
        with record_function("pair_step.match"):
            nn_idx, nn_dist = knn2(desc[:B], desc[B:], m1, m2, metric="l2_int8")
            ok = (nn_dist[..., 0] < RATIO * torch.clamp(nn_dist[..., 1], min=1e-12)) & m1
            p2 = xy2.gather(1, nn_idx[..., :1].long().expand(-1, -1, 2))
        with record_function("pair_step.ransac"):
            if u is None:
                gen = torch.Generator(device=img1.device).manual_seed(0)
                u = draw_uniform(num_hypotheses, 4, gen, img1.device)
            rr = find_homography(xy1, p2, mask=ok, num_hypotheses=num_hypotheses,
                                 refit=False, u=u)
        return {
            "num_matches": ok.sum(-1, dtype=torch.int32),
            "num_inliers": rr.num_inliers,
            "inlier_ratio": rr.inlier_ratio,
            "homography": rr.model,
        }

    return pair_fn
