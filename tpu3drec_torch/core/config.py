"""Config system: presets, deep-merge, validation, save/load, hardware adjust.

Port of `tpu3drec/core/config.py`, data and functions alike: DEFAULT_CONFIG,
the five presets (fast / balanced / accurate / deep_learning / robust),
per-detector and per-matcher defaults, merge + validate + JSON save/load,
and the hardware adjustment, which drops the deep detectors when no
converted weights are on disk. The dictionaries equal the reference's, so a
config written by either package drives the other.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

KNOWN_DETECTORS = (
    "SIFT", "ORB", "AKAZE", "BRISK", "Harris", "GoodFeatures",
    "SuperPoint", "DISK", "ALIKED",
)
DEEP_DETECTORS = ("SuperPoint", "DISK", "ALIKED")
KNOWN_MATCHERS = ("bf", "flann", "lightglue", "auto")
COMBINE_STRATEGIES = ("best", "independent", "weighted")

DEFAULT_CONFIG: Dict[str, Any] = {
    "methods": ["SIFT"],
    "max_features": 2048,
    "combine_strategy": "best",
    "detector_params": {
        "SIFT": {"contrast_threshold": 0.04, "edge_threshold": 10.0, "sigma": 1.6},
    },
    "matcher_config": {"SIFT": "bf"},
    "matcher_params": {},
    "lightglue_configs": {},
    "filtering": {
        "use_adaptive_filtering": True,
        "ransac_threshold": 4.0,
        "top_k": 500,
    },
    # batch-engine knobs (kept with the reference's values):
    "image_size": None,        # (H, W) processing size; None = as decoded
    "pair_batch_size": 8,      # pairs matched per batch of the folder engine
    "precision": "float32",    # compute dtype for detector pyramids
}

PRESET_CONFIGS: Dict[str, Dict[str, Any]] = {
    "fast": {
        "methods": ["ORB"],
        "max_features": 1000,
        "combine_strategy": "best",
        "detector_params": {"ORB": {"scale_factor": 1.5, "n_levels": 6, "edge_threshold": 31}},
        "matcher_config": {"ORB": "bf"},
    },
    "balanced": {
        "methods": ["SIFT", "ORB"],
        "max_features": 2000,
        "combine_strategy": "independent",
        "detector_params": {
            "SIFT": {"contrast_threshold": 0.04},
            "ORB": {"scale_factor": 1.2, "n_levels": 8},
        },
        "matcher_config": {"SIFT": "flann", "ORB": "bf"},
    },
    "accurate": {
        "methods": ["SIFT", "AKAZE", "BRISK"],
        "max_features": 3000,
        "combine_strategy": "independent",
        "detector_params": {
            "SIFT": {"contrast_threshold": 0.03},
            "AKAZE": {"threshold": 0.0005},
            "BRISK": {"threshold": 20},
        },
        "matcher_config": {"SIFT": "flann", "AKAZE": "bf", "BRISK": "bf"},
    },
    "deep_learning": {
        "methods": ["SuperPoint", "DISK"],
        "max_features": 2048,
        "combine_strategy": "independent",
        "detector_params": {"SuperPoint": {"keypoint_threshold": 0.005}, "DISK": {}},
        "matcher_config": {"SuperPoint": "lightglue", "DISK": "lightglue"},
    },
    "robust": {
        "methods": ["SIFT", "AKAZE", "SuperPoint"],
        "max_features": 2500,
        "combine_strategy": "independent",
        "detector_params": {
            "SIFT": {"contrast_threshold": 0.035},
            "AKAZE": {"threshold": 0.0008},
            "SuperPoint": {},
        },
        "matcher_config": {"SIFT": "flann", "AKAZE": "bf", "SuperPoint": "lightglue"},
    },
}

# per-detector full default parameter sets
DETECTOR_SPECIFIC_CONFIGS: Dict[str, Dict[str, Any]] = {
    "SIFT": {"max_features": 5000, "contrast_threshold": 0.04,
             "edge_threshold": 10.0, "sigma": 1.6, "n_octave_layers": 3},
    "ORB": {"max_features": 5000, "scale_factor": 1.2, "n_levels": 8,
            "edge_threshold": 31, "fast_threshold": 20},
    "AKAZE": {"threshold": 0.001, "n_octaves": 4, "n_octave_layers": 4},
    "BRISK": {"threshold": 30, "octaves": 3, "pattern_scale": 1.0},
    "Harris": {"max_features": 5000, "block_size": 3, "k": 0.04,
               "quality_level": 0.01, "min_distance": 10},
    "GoodFeatures": {"max_features": 5000, "quality_level": 0.01,
                     "min_distance": 10, "block_size": 3},
    "SuperPoint": {"keypoint_threshold": 0.005, "nms_radius": 4,
                   "max_features": 2048},
    "DISK": {"max_features": 2048},
    "ALIKED": {"max_features": 2048},
}

MATCHER_SPECIFIC_CONFIGS: Dict[str, Dict[str, Any]] = {
    "bf": {"ratio_threshold": 0.75, "cross_check": False},
    "flann": {"ratio_threshold": 0.7},
    "lightglue": {"confidence_threshold": 0.2, "filter_threshold": 0.1},
}


def merge_configs(base: Dict[str, Any], override: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Recursive deep merge; override wins."""
    out = copy.deepcopy(base)
    if not override:
        return out
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_configs(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def create_config_from_preset(preset: str = "balanced",
                              custom: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Preset -> full config dict."""
    if preset not in PRESET_CONFIGS:
        raise ValueError(f"Unknown preset {preset!r}; choose from {sorted(PRESET_CONFIGS)}")
    cfg = merge_configs(DEFAULT_CONFIG, PRESET_CONFIGS[preset])
    cfg = merge_configs(cfg, custom)
    return cfg


def validate_config(config: Dict[str, Any]) -> List[str]:
    """Return a list of problems; empty list = valid."""
    problems: List[str] = []
    methods = config.get("methods", [])
    if not methods:
        problems.append("config.methods is empty")
    for m in methods:
        if m not in KNOWN_DETECTORS:
            problems.append(f"unknown detector method {m!r}")
    mf = config.get("max_features", 0)
    if not isinstance(mf, int) or mf <= 0:
        problems.append(f"max_features must be a positive int, got {mf!r}")
    strat = config.get("combine_strategy")
    if strat not in COMBINE_STRATEGIES:
        problems.append(f"unknown combine_strategy {strat!r}")
    for det, matcher in (config.get("matcher_config") or {}).items():
        if matcher not in KNOWN_MATCHERS:
            problems.append(f"unknown matcher {matcher!r} for detector {det!r}")
    return problems


def save_config(config: Dict[str, Any], path) -> None:
    Path(path).write_text(json.dumps(config, indent=2, sort_keys=True))


def load_config(path) -> Dict[str, Any]:
    return json.loads(Path(path).read_text())


def adjust_config_for_hardware(config: Dict[str, Any],
                               have_deep_weights: Optional[bool] = None) -> Dict[str, Any]:
    """Drop the deep methods when no converted weights are on disk; fall
    back to SIFT with `bf` if nothing remains."""
    cfg = copy.deepcopy(config)
    if have_deep_weights is None:
        from tpu3drec_torch.models import weights_available
        have_deep_weights = weights_available()
    if not have_deep_weights:
        kept = [m for m in cfg.get("methods", []) if m not in DEEP_DETECTORS]
        if not kept:
            kept = ["SIFT"]
            cfg.setdefault("matcher_config", {})["SIFT"] = "bf"
        cfg["methods"] = kept
    return cfg
