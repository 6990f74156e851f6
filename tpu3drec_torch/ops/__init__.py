"""Ported operators: image primitives, SIFT, matching, RANSAC, geometry,
stereo, point clouds, TSDF and mesh utilities, and the kernel wrappers
(`pallas_sample`, `pallas_match`, `pallas_sgm`)."""
