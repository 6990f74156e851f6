"""Statistical comparison of benchmark runs.

A copy of `tpu3drec/bench/stats.py` (numpy; scipy imported lazily).
Rebuild of StatisticalAnalyzer (reference benchmarking.py:492-583):
Shapiro-Wilk normality gate -> paired t-test / Mann-Whitney U, Cohen's d
effect size, and descriptive stats per method.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def describe(samples: Sequence[float]) -> Dict:
    a = np.asarray(list(samples), np.float64)
    if len(a) == 0:
        return {"n": 0}
    return {
        "n": int(len(a)),
        "mean": float(a.mean()),
        "std": float(a.std(ddof=1)) if len(a) > 1 else 0.0,
        "median": float(np.median(a)),
        "min": float(a.min()),
        "max": float(a.max()),
    }


class StatisticalAnalyzer:
    """benchmarking.py:492-583."""

    @staticmethod
    def cohens_d(a: Sequence[float], b: Sequence[float]) -> float:
        a = np.asarray(list(a), np.float64)
        b = np.asarray(list(b), np.float64)
        na, nb = len(a), len(b)
        if na < 2 or nb < 2:
            return 0.0
        pooled = np.sqrt(((na - 1) * a.var(ddof=1) + (nb - 1) * b.var(ddof=1))
                         / max(na + nb - 2, 1))
        if pooled < 1e-12:
            return 0.0
        return float((a.mean() - b.mean()) / pooled)

    @classmethod
    def compare_methods(cls, a: Sequence[float], b: Sequence[float],
                        alpha: float = 0.05) -> Dict:
        """Normality-gated significance test (:498-560)."""
        from scipy import stats
        a = np.asarray(list(a), np.float64)
        b = np.asarray(list(b), np.float64)
        out: Dict = {"a": describe(a), "b": describe(b),
                     "cohens_d": cls.cohens_d(a, b)}
        if len(a) < 3 or len(b) < 3:
            out["test"] = "insufficient_samples"
            out["p_value"] = None
            out["significant"] = False
            return out
        normal = True
        for s in (a, b):
            if len(s) >= 3:
                try:
                    if stats.shapiro(s).pvalue < alpha:
                        normal = False
                except Exception:
                    normal = False
        if normal:
            t = stats.ttest_ind(a, b, equal_var=False)
            out["test"] = "welch_t"
            out["p_value"] = float(t.pvalue)
        else:
            u = stats.mannwhitneyu(a, b, alternative="two-sided")
            out["test"] = "mann_whitney_u"
            out["p_value"] = float(u.pvalue)
        out["significant"] = bool(out["p_value"] is not None
                                  and out["p_value"] < alpha)
        return out
