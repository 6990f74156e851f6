"""Ported operators: image primitives, SIFT, matching, RANSAC, geometry,
and the kernel wrappers (`pallas_sample`, `pallas_match`)."""
