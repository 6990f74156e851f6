"""Published peaks of one NVIDIA H100 (SXM data sheet, dense rates, at
the full 700 W power limit) and the least time each kernel's work could
take on them: the larger of its operations over the peak rate and its
bytes over the memory bandwidth, each input byte read once and each
output byte written once. The counts follow `chip_smoke.py:knn2_bound`
and its `sgm` bound."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS = 67e12
PEAK_INT8_OPS = 1979e12
SGM_OPS_PER_ELEMENT = 39   # 9 per DP step x 4 directions + 3 sums


def knn2_bound_ms(batch: int, rows: int, cols: int, depth: int,
                  valid_cols: int) -> float:
    """int8 2-NN of `batch` problems of rows x cols at depth D: A, each
    valid column of B and its int32 norm read once, the column mask read
    once, the top-2 indices and values written once; the products of
    every row with every valid column on the int8 tensor cores."""
    bytes_ = (batch * rows * depth + valid_cols * (depth + 4) + batch * cols
              + batch * rows * 2 * 8)
    ops = 2.0 * rows * valid_cols * depth
    return max(bytes_ / PEAK_BYTES_PER_S, ops / PEAK_INT8_OPS) * 1e3


def sgm_bound_ms(elements: int) -> float:
    """4-direction SGM over cost volumes of `elements` float32 values in
    all: the volumes read once and the aggregate written once."""
    return max(2 * elements * 4 / PEAK_BYTES_PER_S,
               SGM_OPS_PER_ELEMENT * elements / PEAK_F32_OPS) * 1e3
