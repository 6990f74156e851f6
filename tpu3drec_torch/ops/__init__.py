"""Ported operators: image primitives, SIFT, matching, RANSAC, geometry,
SfM geometry (`lie`, `five_point`, `epipolar`, `triangulate`, `pnp`) and
bundle adjustment (`ba`), stereo, point clouds, TSDF and mesh utilities,
and the kernel wrappers (`pallas_sample`, `pallas_match`, `pallas_sgm`)."""
