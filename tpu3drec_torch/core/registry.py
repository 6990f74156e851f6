"""Matcher compatibility manager + matcher factory.

Port of `tpu3drec/core/registry.py`: loads matcher_compatibility.json (a
copy of the JAX package's file, same schema and version), validates
detector<->matcher combinations, resolves the matcher for a detector
(explicit config > recommended > default), supplies per-combo parameters,
and prints the compatibility matrix. The factory's kNN matchers run
`ops.match.match_features`; LightGlue is a deep model, not ported yet
(ROADMAP Queue 1 #6).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

_DEFAULT_JSON = Path(__file__).parent / "matcher_compatibility.json"


class MatcherCompatibilityManager:
    """Reads and queries the compatibility JSON."""

    def __init__(self, json_path=None):
        path = Path(json_path) if json_path else _DEFAULT_JSON
        self.data = json.loads(path.read_text())
        self.detectors: Dict[str, Dict] = self.data.get("detectors", {})
        self.matchers: Dict[str, Dict] = self.data.get("matchers", {})

    @property
    def version(self) -> str:
        return self.data.get("version", "unknown")

    def is_compatible(self, detector: str, matcher: str) -> bool:
        d = self.detectors.get(detector)
        return bool(d and matcher in d.get("compatible_matchers", []))

    def get_default_matcher(self, detector: str) -> Optional[str]:
        return self.detectors.get(detector, {}).get("default_matcher")

    def get_recommended_matcher(self, detector: str) -> Optional[str]:
        return self.detectors.get(detector, {}).get("recommended_matcher")

    def get_matcher_params(self, detector: str, matcher: str) -> Dict:
        return dict(self.detectors.get(detector, {})
                    .get("matcher_params", {}).get(matcher, {}))

    def descriptor_info(self, detector: str) -> Dict:
        d = self.detectors.get(detector, {})
        return {"type": d.get("descriptor_type"),
                "size": d.get("descriptor_size")}

    def validate_configuration(self, detector: str,
                               matcher: Optional[str]) -> List[str]:
        problems = []
        if detector not in self.detectors:
            problems.append(f"unknown detector {detector!r}")
            return problems
        if matcher and matcher != "auto" and \
                not self.is_compatible(detector, matcher):
            problems.append(
                f"matcher {matcher!r} incompatible with {detector!r}; "
                f"compatible: {self.detectors[detector]['compatible_matchers']}")
        return problems

    def print_compatibility_matrix(self) -> str:
        names = sorted(self.matchers)
        lines = [f"{'detector':<14}" + "".join(f"{m:>12}" for m in names)]
        for det in sorted(self.detectors):
            row = f"{det:<14}"
            for m in names:
                mark = "+" if self.is_compatible(det, m) else "-"
                if self.get_recommended_matcher(det) == m:
                    mark = "*"
                row += f"{mark:>12}"
            lines.append(row)
        lines.append("(*: recommended, +: compatible, -: incompatible)")
        matrix = "\n".join(lines)
        print(matrix)
        return matrix


class MatcherFactory:
    """Builds a configured matcher callable."""

    def __init__(self, compat: Optional[MatcherCompatibilityManager] = None):
        self.compat = compat or MatcherCompatibilityManager()

    def _determine_matcher_type(self, detector: str,
                                requested: Optional[str]) -> str:
        """explicit > recommended > default."""
        if requested and requested != "auto":
            problems = self.compat.validate_configuration(detector, requested)
            if problems:
                raise ValueError("; ".join(problems))
            return requested
        return (self.compat.get_recommended_matcher(detector)
                or self.compat.get_default_matcher(detector) or "bf")

    def create_matcher(self, detector: str,
                       matcher: Optional[str] = None,
                       **overrides) -> Callable:
        """Returns match_fn(features1, features2) -> Matches."""
        mtype = self._determine_matcher_type(detector, matcher)
        params = self.compat.get_matcher_params(detector, mtype)
        params.update(overrides)

        if mtype == "lightglue":
            raise NotImplementedError(
                "tpu3drec_torch: the LightGlue matcher is a deep model, not "
                "ported yet (ROADMAP Queue 1 #6)")

        ratio = params.get("ratio_threshold",
                           0.7 if mtype == "flann" else 0.75)
        cross = params.get("cross_check", False)

        def knn_match(f1, f2):
            from tpu3drec_torch.ops.match import match_features
            return match_features(f1, f2, ratio=ratio, cross_check=cross)

        return knn_match
