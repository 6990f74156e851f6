"""The port's incremental SfM pipeline (tpu3drec_torch.sfm.pipeline) on the
JAX tests' synthetic scenes, on the CPU.

The reference pipeline runs once, on `tests/test_sfm_pipeline.py`'s
`make_scene()` (5 views, 250 points). The port's run on the same input
must meet that test's bars (every view registered, more than 75 points,
observations above 1.6x the points, mean reprojection < 1.5 px,
consecutive relative rotations within 2 deg of the truth), register the
same views from the same init pair as the reference, keep its
consecutive relative rotations within 0.5 deg of the reference's, and
write the reference's export files. Torch cannot reproduce JAX's random
bits, so counts are compared by these bars, not exactly.

The other cases run the port alone at the reference tests' sizes, with
those tests' bars: batch pickles, checkpoint and resume (also from a
checkpoint the reference wrote), iterative refinement, the progressive
rescue of a weakly connected folder, local against full-map BA, and the
device policy.
"""

import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_sfm_pipeline import make_scene, make_weak_scene      # noqa: E402

from tpu3drec.sfm import SfMPipeline as JPipeline              # noqa: E402
from tpu3drec.sfm.pipeline import SfMConfig as JConfig         # noqa: E402
from tpu3drec.sfm.reconstruction import Reconstruction as JRecon  # noqa: E402
import tpu3drec_torch as tv                                    # noqa: E402
from tpu3drec_torch.sfm.quality import assess_reconstruction_quality  # noqa: E402

ROT_GT_DEG = 2.0
ROT_REF_DEG = 0.5


def rel_rotation_errors(recon, Rs, names):
    """Angle (deg) of each consecutive registered pair's relative rotation
    against the rotations Rs[i] of names[i]."""
    out = []
    for a in range(len(names) - 1):
        b = a + 1
        if names[a] not in recon.cameras or names[b] not in recon.cameras:
            continue
        R_est = recon.cameras[names[b]].R @ recon.cameras[names[a]].R.T
        d = R_est @ (Rs[b] @ Rs[a].T).T
        out.append(np.degrees(np.arccos(np.clip((np.trace(d) - 1) / 2, -1, 1))))
    return np.asarray(out)


def init_pair(pipe):
    return tuple(next(h for h in pipe.history if h["phase"] == "init")["pair"])


def files_under(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    scene = make_scene()
    matches_data, image_info, views, X, K, names = scene
    jout = tmp_path_factory.mktemp("ref")
    jpipe = JPipeline(JConfig())
    jrec = jpipe.reconstruct(matches_data, image_info, output_dir=jout)
    tout = tmp_path_factory.mktemp("port")
    tpipe = tv.SfMPipeline(tv.SfMConfig(), device="cpu")
    trec = tpipe.reconstruct(matches_data, image_info, output_dir=tout)
    return scene, (jpipe, jrec, jout), (tpipe, trec, tout)


def test_config_carries_reference_fields():
    import dataclasses
    ref = JConfig()
    fields = {k: v for k, v in dataclasses.asdict(ref).items()
              if k != "prewarm_compile"}
    assert dataclasses.asdict(tv.SfMConfig(**fields)) == fields
    assert dataclasses.asdict(tv.SfMConfig()) == fields


def test_registers_reference_views_from_reference_pair(runs):
    (md, info, views, X, K, names), (jpipe, jrec, _), (tpipe, trec, _) = runs
    assert trec.num_cameras == len(names), sorted(trec.cameras)
    assert set(trec.cameras) == set(jrec.cameras)
    assert init_pair(tpipe) == init_pair(jpipe)
    assert trec.num_points > 75
    assert trec.num_observations > 2 * trec.num_points * 0.8
    adds = [h for h in tpipe.history if h["phase"] == "add_view"]
    for k in ("rank_s", "mine_s", "pnp_s", "tri_s", "prog_s", "ext_s",
              "ba_s", "ba_iters"):
        assert all(k in h for h in adds), k


def test_reprojection_and_rotations(runs):
    (md, info, views, X, K, names), (jpipe, jrec, _), (tpipe, trec, _) = runs
    q = assess_reconstruction_quality(trec)
    assert q["mean_reprojection_error"] < 1.5, q
    assert q["quality_level"] in ("good", "excellent", "fair")
    gt = [R for R, _ in views]
    terr = rel_rotation_errors(trec, gt, names)
    assert len(terr) == len(names) - 1 and terr.max() < ROT_GT_DEG, terr
    t_rel = [trec.cameras[n].R for n in names]
    j_rel = [jrec.cameras[n].R for n in names]
    assert rel_rotation_errors(trec, j_rel, names).max() < ROT_REF_DEG
    assert rel_rotation_errors(jrec, t_rel, names).max() < ROT_REF_DEG


def test_exports_match_reference_files(runs):
    _, (jpipe, jrec, jout), (tpipe, trec, tout) = runs
    assert files_under(tout) == files_under(jout)
    a = pickle.load(open(tout / "optimized_camera_poses.pkl", "rb"))
    b = pickle.load(open(jout / "optimized_camera_poses.pkl", "rb"))
    assert set(a) == set(b)
    assert set(a["camera_poses"]) == set(b["camera_poses"]) == set(trec.cameras)
    for n in a["camera_poses"]:
        assert set(a["camera_poses"][n]) == set(b["camera_poses"][n])
    ra = json.loads((tout / "reconstruction_report.json").read_text())
    rb = json.loads((jout / "reconstruction_report.json").read_text())
    assert set(ra) == set(rb)
    assert set(ra["quality"]) == set(rb["quality"])
    assert ra["statistics"]["num_cameras"] == trec.num_cameras
    assert [h["phase"] for h in ra["history"]] == [h["phase"] for h in rb["history"]]


def test_reconstruct_scene_from_pickles(tmp_path):
    from tpu3drec.io.batch_pickle import save_batch, save_image_metadata
    from tpu3drec.io.images import ImageMetadata
    matches_data, image_info, views, X, K, names = make_scene(n_views=3)
    save_batch(tmp_path, "results", 0, matches_data,
               config={"feature_type": "SIFT"})
    save_image_metadata(tmp_path, "results", [
        ImageMetadata(name=n, path=n, width=640, height=480) for n in names])
    recon = tv.reconstruct_scene(str(tmp_path / "results_batch_000.pkl"),
                                 output_dir=tmp_path / "out", device="cpu")
    assert recon.num_cameras == 3
    assert assess_reconstruction_quality(recon)["mean_reprojection_error"] < 1.5
    assert (tmp_path / "out" / "colmap" / "points3D.txt").exists()


def test_checkpoint_and_resume(tmp_path):
    matches_data, image_info, views, X, K, names = make_scene(n_views=4)
    ckpt = tmp_path / "ckpt"
    recon = tv.SfMPipeline(device="cpu").reconstruct(
        matches_data, image_info, checkpoint_dir=ckpt)
    assert (ckpt / "sfm_checkpoint.pkl").exists()
    assert recon.num_cameras == 4

    pipe2 = tv.SfMPipeline(device="cpu")
    recon2 = pipe2.reconstruct(matches_data, image_info,
                               checkpoint_dir=ckpt, resume=True)
    assert pipe2.history[0]["phase"] == "resume"
    assert recon2.num_cameras == 4
    assert assess_reconstruction_quality(recon2)["mean_reprojection_error"] < 2.0

    # a checkpoint that the reference wrote (its Reconstruction.save_state
    # of the port's checkpoint, cut to the first two cameras' state)
    ref_state = JRecon.load_state(ckpt / "sfm_checkpoint.pkl")
    keep = list(ref_state.cameras)[:2]
    cut = JRecon()
    for n in keep:
        cut.add_camera(ref_state.cameras[n])
    cut.add_points_batch(ref_state.points)
    for n in keep:
        cut.add_observations_batch(n, *ref_state.camera_obs_arrays(n))
    rdir = tmp_path / "ref_ckpt"
    rdir.mkdir()
    cut.save_state(rdir / "sfm_checkpoint.pkl")
    pipe3 = tv.SfMPipeline(device="cpu")
    recon3 = pipe3.reconstruct(matches_data, image_info, checkpoint_dir=rdir)
    assert pipe3.history[0] == {"phase": "resume", "cameras": 2,
                                "points": ref_state.num_points}
    assert recon3.num_cameras == 4
    assert assess_reconstruction_quality(recon3)["mean_reprojection_error"] < 2.0
    # and the reference reads the port's newest checkpoint back
    assert JRecon.load_state(rdir / "sfm_checkpoint.pkl").num_cameras == 4


def test_iterative_refinement_flag():
    matches_data, image_info, views, X, K, names = make_scene(n_views=3)
    pipe = tv.SfMPipeline(tv.SfMConfig(use_iterative_refinement=True),
                          device="cpu")
    recon = pipe.reconstruct(matches_data, image_info)
    assert recon.num_cameras == 3
    assert assess_reconstruction_quality(recon)["mean_reprojection_error"] < 2.0


def test_progressive_rescues_weakly_connected_folder():
    matches_data, image_info, names = make_weak_scene()
    base = tv.SfMPipeline(tv.SfMConfig(enable_progressive=False,
                                       enable_track_extension=False),
                          device="cpu").reconstruct(dict(matches_data),
                                                    dict(image_info))
    prog = tv.SfMPipeline(tv.SfMConfig(), device="cpu").reconstruct(
        dict(matches_data), dict(image_info))
    assert base.num_cameras < len(names)
    assert prog.num_cameras == len(names), sorted(prog.cameras)
    assert prog.num_points >= 1.5 * max(base.num_points, 1), \
        (prog.num_points, base.num_points)
    assert assess_reconstruction_quality(prog)["mean_reprojection_error"] < 2.0


def test_local_against_full_map_ba():
    from tpu3drec_torch.bench.synthetic import make_sfm_scene
    matches_data, info, gt = make_sfm_scene(n_views=6, n_pts=600)
    out = {}
    for local in (True, False):
        recon = tv.SfMPipeline(tv.SfMConfig(use_local_ba=local),
                               device="cpu").reconstruct(dict(matches_data), info)
        out[local] = (recon.num_cameras,
                      assess_reconstruction_quality(recon)["mean_reprojection_error"])
    assert out[True][0] == out[False][0] == 6
    assert out[True][1] < max(2.0, 2.0 * out[False][1]), out


def test_device_none_means_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tv.SfMPipeline()
    with pytest.raises(RuntimeError, match="CUDA"):
        tv.reconstruct_scene({})


def test_sharded_global_ba_is_not_run_on_one_card(monkeypatch):
    matches_data, image_info, *_ = make_scene(n_views=3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    pipe = tv.SfMPipeline(tv.SfMConfig(sharded_ba_min_obs=10), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 #10"):
        pipe.reconstruct(matches_data, image_info)
    # without the sharded request the single-device solve runs
    recon = tv.SfMPipeline(tv.SfMConfig(use_sharded_global_ba=False),
                           device="cpu").reconstruct(matches_data, image_info)
    assert recon.num_cameras == 3
