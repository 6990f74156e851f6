"""A run whose timed path is broken underneath reads `correct` false.

Each test plants one fault in the program, as a later change could,
drives the rest of a run on the CPU at a tiny size (skipping only the
look for a card) and reads the result with the cell's own limits. The
faults a cell can have: a step that returns its state unchanged (a stale
answer), half of the batch left out, and an answer altered where it is
produced. No cell runs across chips, so no exchange can be left out; a
dense run's inputs are the same every run, so a stale answer there is
the right one."""

import time

import pytest
import torch

from recbench import harness
from recbench.tests.conftest import DENSE, load, shrink

PAIRS = "pairs.sift-vga-2048.b8"


def _run(name):
    cell = shrink(load(name))
    return harness.run_cell(cell, 11, 0.3, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", [PAIRS, DENSE])
def test_sound_runs_are_correct(name, exact_neighbours):
    assert _run(name)["correct"] is True


def test_dense_voxel_neighbours_fail():
    """The program as it stands: its voxel-hash neighbours put the normals
    and the cloud's statistics far from the reference's, and nothing
    else. This fault parks the dense cell; once it is mended this test
    fails, and the cell can go back into BENCHMARK.json."""
    checks = _run(DENSE)["checks"]
    failed = {k for k, c in checks.items()
              if c["value"] is None or c["value"] > c["limit"]}
    assert failed == {"normals_off_pct", "cloud_quality_gap_rel",
                      "cloud_clusters_gap"}


def _wrap_pair_fn(monkeypatch, wrap):
    import tpu3drec_torch.pair_step as ps
    real = ps.make_pair_fn
    monkeypatch.setattr(ps, "make_pair_fn",
                        lambda *a, **kw: wrap(real(*a, **kw)))


def test_pairs_stale_answer(monkeypatch):
    """The step hands back its first answer on every call."""
    def wrap(fn):
        first = {}

        def stale(img1, img2, u=None):
            if not first:
                first.update(fn(img1, img2, u))
            return dict(first)
        return stale

    _wrap_pair_fn(monkeypatch, wrap)
    assert _run(PAIRS)["correct"] is False


def test_pairs_half_the_batch(monkeypatch):
    """Only the first half of each batch is computed; its answers stand
    for the rest."""
    def wrap(fn):
        def half(img1, img2, u=None):
            h = img1.shape[0] // 2
            out = fn(img1[:h], img2[:h], u)
            return {k: torch.cat([v, v[:img1.shape[0] - h]])
                    for k, v in out.items()}
        return half

    _wrap_pair_fn(monkeypatch, wrap)
    assert _run(PAIRS)["correct"] is False


def test_pairs_altered_homography(monkeypatch):
    """RANSAC's model is shifted by 2 px where it is produced."""
    import tpu3drec_torch.pair_step as ps
    real = ps.find_homography

    def shifted(*a, **kw):
        rr = real(*a, **kw)
        m = rr.model.clone()
        m[:, 0, 2] += 2.0 * m[:, 2, 2]
        return rr._replace(model=m)

    monkeypatch.setattr(ps, "find_homography", shifted)
    assert _run(PAIRS)["correct"] is False


def test_pairs_altered_match_count(monkeypatch):
    """The ratio test lets one pair's matches through at 0.8."""
    import tpu3drec_torch.pair_step as ps
    monkeypatch.setattr(ps, "RATIO", 0.8)
    assert _run(PAIRS)["correct"] is False


def test_dense_half_the_views(monkeypatch, exact_neighbours):
    from tpu3drec_torch.pipelines import dense as pd
    real = pd.DenseReconstructionPipeline._stereo

    def half(self, img_ref, images, others, *a):
        return real(self, img_ref, images, others[:len(others) // 2], *a)

    monkeypatch.setattr(pd.DenseReconstructionPipeline, "_stereo", half)
    assert _run(DENSE)["correct"] is False


@pytest.mark.parametrize("name", ["stereo_depth_pairs_fused",
                                  "fuse_depth_blocks"])
def test_dense_altered_depth(monkeypatch, name, exact_neighbours):
    """The fused depth is scaled by 1.01 where it is produced (the fused
    path for up to six neighbours, blocks beyond)."""
    from tpu3drec_torch.pipelines import dense as pd
    real = getattr(pd, name)

    def scaled(*a, **kw):
        out = real(*a, **kw)
        out["fused_depth"] = out["fused_depth"] * 1.01
        return out

    monkeypatch.setattr(pd, name, scaled)
    if name == "fuse_depth_blocks":
        monkeypatch.setattr(pd, "_FUSED_MAX", 1)
    assert _run(DENSE)["correct"] is False


def test_dense_normals_from_fewer_neighbours(monkeypatch, exact_neighbours):
    """Normals are fitted to 4 neighbours instead of 16 where they are
    made (both of the stage's neighbour searches)."""
    from tpu3drec_torch.ops import pointcloud as pc
    for name in ("estimate_normals", "estimate_normals_scaled"):
        real = getattr(pc, name)
        monkeypatch.setattr(pc, name, lambda p, m, k=16, viewpoint=None,
                            real=real: real(p, m, k=4, viewpoint=viewpoint))
    assert _run(DENSE)["correct"] is False


def test_dense_cloud_statistics_from_half_the_points(monkeypatch,
                                                    exact_neighbours):
    """The cloud's quality statistics are taken over every second point."""
    from tpu3drec_torch.ops import pointcloud as pc
    real = pc.point_cloud_quality
    monkeypatch.setattr(pc, "point_cloud_quality",
                        lambda points, *a, **kw: real(points[::2], *a, **kw))
    assert _run(DENSE)["correct"] is False


def test_dense_mesh_left_unsmoothed(monkeypatch, exact_neighbours):
    """The mesh's Laplacian smoothing returns the vertices unmoved."""
    import numpy as np
    from tpu3drec_torch.ops import mesh as mesh_ops
    monkeypatch.setattr(mesh_ops, "smooth_mesh",
                        lambda v, f, **kw: (np.asarray(v, np.float64), f))
    assert _run(DENSE)["correct"] is False
