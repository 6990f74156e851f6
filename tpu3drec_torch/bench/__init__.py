"""Benchmark inputs, quality metrics, statistics and the unified runner."""

from tpu3drec_torch.bench.synthetic import (
    SyntheticImageGenerator, create_transform_pair, make_sfm_scene,
)
from tpu3drec_torch.bench.metrics import AdvancedQualityMetrics
from tpu3drec_torch.bench.stats import StatisticalAnalyzer
from tpu3drec_torch.bench.runner import (
    UnifiedBenchmarkConfig, UnifiedBenchmarkPipeline,
    quick_synthetic_benchmark, quick_folder_benchmark,
)
