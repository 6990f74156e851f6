"""Per-detector and per-matcher defaults for the ported methods.

The SIFT and `bf`/`flann` entries of `tpu3drec/core/config.py`; the other
detectors and matchers come with their slices of the port.
"""

from __future__ import annotations

from typing import Any, Dict

DETECTOR_SPECIFIC_CONFIGS: Dict[str, Dict[str, Any]] = {
    "SIFT": {"max_features": 5000, "contrast_threshold": 0.04,
             "edge_threshold": 10.0, "sigma": 1.6, "n_octave_layers": 3},
}

MATCHER_SPECIFIC_CONFIGS: Dict[str, Dict[str, Any]] = {
    "bf": {"ratio_threshold": 0.75, "cross_check": False},
    "flann": {"ratio_threshold": 0.7},
}
