"""Core data model, configuration presets, the matcher registry,
multi-method match merging and device policy."""

from tpu3drec_torch.core.types import (
    Features, Matches, ScoreType, MethodResult, MatchingResult,
)
from tpu3drec_torch.core.config import (
    DEFAULT_CONFIG,
    PRESET_CONFIGS,
    create_config_from_preset,
    merge_configs,
    validate_config,
)

__all__ = [
    "DEFAULT_CONFIG",
    "Features",
    "Matches",
    "MatchingResult",
    "MethodResult",
    "PRESET_CONFIGS",
    "ScoreType",
    "create_config_from_preset",
    "merge_configs",
    "validate_config",
]
