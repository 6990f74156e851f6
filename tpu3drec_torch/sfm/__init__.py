"""Ported structure-from-motion modules: two-view iterative refinement
(`refinement`)."""
