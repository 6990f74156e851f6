"""Core data model: fixed-capacity, mask-padded tensor bundles.

Port of `tpu3drec/core/types.py`. Keypoints and matches are `(N, ...)`
tensors padded to a static capacity with a validity mask, so a batch of
images is one tensor with a leading batch dimension. `to_numpy` and
`from_numpy` use exactly the reference's keys and padding rules, so each
package reads the other's output.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

from tpu3drec_torch.core.device import resolve_device


class ScoreType(str, enum.Enum):
    """Match score semantics."""

    DISTANCE = "distance"      # lower is better (L2 / Hamming)
    CONFIDENCE = "confidence"  # higher is better, in [0, 1]
    SIMILARITY = "similarity"  # higher is better, unbounded


class DescriptorKind(str, enum.Enum):
    """Descriptor family — decides the kNN metric and storage layout."""

    FLOAT = "float"    # float descriptors (SIFT, ...): L2 metric
    BINARY = "binary"  # binary descriptors stored as +-1: Hamming
    NONE = "none"      # detector produced no descriptors


@dataclasses.dataclass
class Features:
    """Padded keypoints + descriptors for one image.

    All tensors share the leading capacity `N`; `mask` marks valid rows.
    """

    xy: torch.Tensor        # (N, 2) float32 — keypoint (x, y) pixel coords
    response: torch.Tensor  # (N,)  float32 — detector response
    scale: torch.Tensor     # (N,)  float32 — keypoint size (diameter, px)
    angle: torch.Tensor     # (N,)  float32 — orientation, radians
    desc: torch.Tensor      # (N, D) float32 descriptors (+-1 for binary)
    mask: torch.Tensor      # (N,)  bool — True for valid keypoints

    method: str = "unknown"
    desc_kind: str = DescriptorKind.FLOAT.value
    score_type: str = ScoreType.DISTANCE.value
    image_shape: tuple = ()

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]

    @property
    def num_valid(self) -> torch.Tensor:
        return self.mask.sum()

    def __len__(self) -> int:
        return int(self.num_valid)

    def replace(self, **kw) -> "Features":
        return dataclasses.replace(self, **kw)

    @classmethod
    def empty(cls, capacity: int, desc_dim: int, method: str = "unknown",
              desc_kind: str = DescriptorKind.FLOAT.value,
              image_shape: tuple = (), device=None) -> "Features":
        dev = resolve_device(device)
        z = functools.partial(torch.zeros, dtype=torch.float32, device=dev)
        return cls(xy=z(capacity, 2), response=z(capacity),
                   scale=z(capacity), angle=z(capacity),
                   desc=z(capacity, desc_dim),
                   mask=torch.zeros(capacity, dtype=torch.bool, device=dev),
                   method=method, desc_kind=desc_kind,
                   image_shape=image_shape)

    def to(self, device) -> "Features":
        """The same Features with every tensor on `device`."""
        return self.replace(xy=self.xy.to(device),
                            response=self.response.to(device),
                            scale=self.scale.to(device),
                            angle=self.angle.to(device),
                            desc=self.desc.to(device),
                            mask=self.mask.to(device))

    def top_k(self, k: int) -> "Features":
        """Keep the k strongest valid keypoints, strongest first (ties to
        the lower index, as the reference's stable argsort)."""
        score = torch.where(self.mask, self.response,
                            torch.full_like(self.response, -float("inf")))
        idx = torch.argsort(-score, stable=True)[:k]
        return self.replace(xy=self.xy[idx], response=self.response[idx],
                            scale=self.scale[idx], angle=self.angle[idx],
                            desc=self.desc[idx], mask=self.mask[idx])

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Dense (unpadded) numpy view, for IO / serialization."""
        m = self.mask.cpu().numpy()
        return {
            "xy": self.xy.cpu().numpy()[m],
            "response": self.response.cpu().numpy()[m],
            "scale": self.scale.cpu().numpy()[m],
            "angle": self.angle.cpu().numpy()[m],
            "desc": self.desc.cpu().numpy()[m],
            "method": self.method,
            "desc_kind": self.desc_kind,
            "image_shape": self.image_shape,
        }

    @classmethod
    def from_numpy(cls, xy, desc, response=None, scale=None, angle=None,
                   capacity: Optional[int] = None, method: str = "unknown",
                   desc_kind: str = DescriptorKind.FLOAT.value,
                   image_shape: tuple = (), device=None) -> "Features":
        """Build a padded Features from dense host arrays."""
        dev = resolve_device(device)
        xy = np.asarray(xy, np.float32).reshape(-1, 2)
        n = xy.shape[0]
        if desc is not None:
            desc = np.asarray(desc, np.float32)
            desc = (desc.reshape(n, -1) if n else
                    desc.reshape(0, desc.shape[-1] if desc.ndim else 0))
        else:
            desc = np.zeros((n, 0), np.float32)
        cap = capacity or max(n, 1)
        d = desc.shape[1]

        def pad(a, shape):
            out = np.zeros(shape, np.float32)
            out[:n] = a[:cap]
            return torch.from_numpy(out).to(dev)

        def or_default(a, fill):
            return (np.asarray(a, np.float32) if a is not None
                    else np.full(n, fill, np.float32))

        return cls(
            xy=pad(xy, (cap, 2)),
            response=pad(or_default(response, 1.0), (cap,)),
            scale=pad(or_default(scale, 1.0), (cap,)),
            angle=pad(or_default(angle, 0.0), (cap,)),
            desc=pad(desc, (cap, d)),
            mask=torch.from_numpy(np.arange(cap) < n).to(dev),
            method=method,
            desc_kind=desc_kind,
            image_shape=tuple(image_shape),
        )


@dataclasses.dataclass
class Matches:
    """Padded match set between two Features: `idx1[i] -> idx2[i]` with a
    per-match `score`; `mask` marks valid rows."""

    idx1: torch.Tensor   # (M,) int32 — indices into features1
    idx2: torch.Tensor   # (M,) int32 — indices into features2
    score: torch.Tensor  # (M,) float32 — distance or confidence
    mask: torch.Tensor   # (M,) bool

    score_type: str = ScoreType.DISTANCE.value
    method: str = "unknown"

    @property
    def capacity(self) -> int:
        return self.idx1.shape[0]

    @property
    def num_valid(self) -> torch.Tensor:
        return self.mask.sum()

    def __len__(self) -> int:
        return int(self.num_valid)

    def replace(self, **kw) -> "Matches":
        return dataclasses.replace(self, **kw)

    def as_distance(self) -> torch.Tensor:
        """Per-match distance-like score (lower = better)."""
        if self.score_type == ScoreType.DISTANCE.value:
            return self.score
        return 1.0 - self.score

    def quality(self) -> torch.Tensor:
        """Per-match normalized quality (higher = better) in [0, 1]."""
        if self.score_type == ScoreType.DISTANCE.value:
            return 1.0 - torch.clamp(self.score, max=1.0)
        return self.score

    def filter_by_score(self, threshold: float) -> "Matches":
        """Keep matches better than threshold."""
        if self.score_type == ScoreType.DISTANCE.value:
            keep = self.score <= threshold
        else:
            keep = self.score >= threshold
        return self.replace(mask=self.mask & keep)

    def top_k(self, k: int) -> "Matches":
        """Keep the k best valid matches, sorted best-first (ties to the
        lower index)."""
        q = torch.where(self.mask, self.quality(),
                        torch.full_like(self.score, -float("inf")))
        idx = torch.argsort(-q, stable=True)[:k]
        return self.replace(idx1=self.idx1[idx], idx2=self.idx2[idx],
                            score=self.score[idx], mask=self.mask[idx])

    def gather_points(self, feats1: Features, feats2: Features):
        """(M,2),(M,2) matched coordinates (invalid rows are garbage — mask!)."""
        return feats1.xy[self.idx1.long()], feats2.xy[self.idx2.long()]

    def to_numpy(self) -> Dict[str, np.ndarray]:
        m = self.mask.cpu().numpy()
        return {
            "idx1": self.idx1.cpu().numpy()[m],
            "idx2": self.idx2.cpu().numpy()[m],
            "score": self.score.cpu().numpy()[m],
            "score_type": self.score_type,
            "method": self.method,
        }

    @classmethod
    def from_numpy(cls, idx1, idx2, score=None,
                   capacity: Optional[int] = None,
                   score_type: str = ScoreType.DISTANCE.value,
                   method: str = "unknown", device=None) -> "Matches":
        """Build a padded Matches from dense host arrays (the inverse of
        `to_numpy`, padded like `Features.from_numpy`)."""
        dev = resolve_device(device)
        idx1 = np.asarray(idx1, np.int32).reshape(-1)
        n = idx1.shape[0]
        cap = capacity or max(n, 1)

        def pad(a, dtype):
            out = np.zeros((cap,), dtype)
            out[:n] = np.asarray(a, dtype).reshape(-1)[:cap]
            return torch.from_numpy(out).to(dev)

        return cls(
            idx1=pad(idx1, np.int32),
            idx2=pad(idx2, np.int32),
            score=pad(score if score is not None else np.zeros(n),
                      np.float32),
            mask=torch.from_numpy(np.arange(cap) < n).to(dev),
            score_type=score_type,
            method=method,
        )


@dataclasses.dataclass
class MethodResult:
    """Per-method result for one image pair."""

    method: str
    features1: Features
    features2: Features
    matches: Matches                  # raw matches
    filtered_matches: Optional[Matches] = None
    homography: Optional[np.ndarray] = None
    inlier_ratio: Optional[float] = None
    reprojection_error: Optional[float] = None
    detection_time: float = 0.0
    matching_time: float = 0.0
    matcher_used: str = ""
    # why the method produced no result, when it failed on this pair
    error: Optional[str] = None

    @property
    def best_matches(self) -> Matches:
        return (self.filtered_matches if self.filtered_matches is not None
                else self.matches)

    @property
    def num_matches(self) -> int:
        return len(self.best_matches)

    @property
    def num_raw_matches(self) -> int:
        return len(self.matches)

    @property
    def total_time(self) -> float:
        return self.detection_time + self.matching_time

    def get_quality_score(self) -> float:
        """Ranking score: 0.4*min(n/500, 1) + 0.4*inlier_ratio
        + 0.2*max(0, 1 - reproj/10)."""
        score = 0.0
        if self.num_matches > 0:
            score += min(self.num_matches / 500.0, 1.0) * 0.4
        if self.inlier_ratio is not None:
            score += self.inlier_ratio * 0.4
        if self.reprojection_error is not None:
            score += max(0.0, 1.0 - self.reprojection_error / 10.0) * 0.2
        return score


@dataclasses.dataclass
class MatchingResult:
    """Multi-method container for one image pair: dict-like access by
    method name, ranking and best-method selection."""

    results: Dict[str, MethodResult]
    image1_name: str = ""
    image2_name: str = ""
    image1_shape: tuple = ()
    image2_shape: tuple = ()
    total_processing_time: float = 0.0
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __getitem__(self, method: str) -> MethodResult:
        return self.results[method]

    def __contains__(self, method: str) -> bool:
        return method in self.results

    def keys(self):
        return self.results.keys()

    def values(self):
        return self.results.values()

    def items(self):
        return self.results.items()

    def rank_methods(self):
        """Methods sorted by quality score, best first (stable: ties keep
        the configured order)."""
        return sorted(self.results.items(),
                      key=lambda kv: kv[1].get_quality_score(), reverse=True)

    def get_best(self) -> Optional[MethodResult]:
        """Best method by quality score."""
        ranked = self.rank_methods()
        return ranked[0][1] if ranked else None

    def get_best_method_name(self) -> Optional[str]:
        ranked = self.rank_methods()
        return ranked[0][0] if ranked else None

    def summary(self) -> Dict[str, Any]:
        return {
            "pair": (self.image1_name, self.image2_name),
            "methods": {
                name: {
                    "num_matches": r.num_matches,
                    "num_raw_matches": r.num_raw_matches,
                    "inlier_ratio": r.inlier_ratio,
                    "reprojection_error": r.reprojection_error,
                    "quality_score": r.get_quality_score(),
                    "total_time": r.total_time,
                }
                for name, r in self.results.items()
            },
            "best_method": self.get_best_method_name(),
            "total_processing_time": self.total_processing_time,
        }


def pack_binary_descriptors(bits: np.ndarray) -> np.ndarray:
    """(N, D) {0,1} -> (N, D) +-1 float32 for Hamming matching by a dot
    product."""
    return (np.asarray(bits, np.float32) * 2.0 - 1.0)


def hamming_from_pm1(dot, dim: int):
    """Recover Hamming distance from a +-1 descriptor dot product."""
    return (dim - dot) * 0.5
