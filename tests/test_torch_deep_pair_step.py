"""The deep pair step (`tpu3drec_torch.pair_step.make_deep_pair_fn`) and
the models under it against the plain reference
`tests/plain_superpoint_lightglue.py`, on random parameters that the
reference draws (every weight, bias and norm term nonzero) and the
program loads, at a small size on the CPU: 2 pairs of 64x96 images,
SuperPoint keeping 64 keypoints, LightGlue at width 64, 4 heads and 2
layers.

Both sides compute in float32 here and sum in different orders, so the
bars sit a few hundred ulps above what they differ by (observed gaps in
brackets): scores within SCORE_TOL (5.6e-9; the scores are cell
probabilities of 0.019-0.020), descriptors within DESC_TOL of 1 - cos
(3.6e-7, the rounding of a float32 dot product of unit vectors),
LightGlue's log-assignment within LG_TOL (2.2e-5 at values of -9.6 to
-14.2, ~20 ulps) and its matchability logits within Z_TOL (1.7e-6).
Keypoints are the same pixels, but for ties within SCORE_TOL of the
budget's last score. A planted fault in LightGlue, a dropped bias
included, puts the log-assignment 0.1 or more away."""

import ast
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_threads import torch_threads  # noqa: F401  (autouse)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import plain_superpoint_lightglue as ref  # noqa: E402
from tpu3drec_torch.core.types import Features  # noqa: E402
from tpu3drec_torch.models import lightglue as tlg  # noqa: E402
from tpu3drec_torch.models.lightglue import (  # noqa: E402
    LightGlue, LightGlueNet,
)
from tpu3drec_torch.models.superpoint import (  # noqa: E402
    SuperPoint, SuperPointNet,
)
from tpu3drec_torch.ops.geometry import find_homography  # noqa: E402
from tpu3drec_torch.ops.ransac import draw_uniform  # noqa: E402
from tpu3drec_torch.pair_step import (  # noqa: E402
    deep_ransac, make_deep_pair_fn,
)
from tpu3drec_torch.utils import profiling  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, K, B = 64, 96, 64, 2
HEADS, SIZE = 4, (H, W)
SCORE_TOL = 1e-6
DESC_TOL = 2e-6
LG_TOL = 2e-4
Z_TOL = 2e-5


def _photos(seed):
    """Two pairs of band-limited noise photos, the second view of each a
    small rotation and shift of the first."""
    g = torch.Generator().manual_seed(seed)
    img = torch.zeros(2 * B, 1, H, W)
    for s in (4, 8, 16):
        img += torch.nn.functional.interpolate(
            torch.rand(2 * B, 1, H // s + 1, W // s + 1, generator=g),
            size=(H, W), mode="bicubic", align_corners=False)
    img = img[:, 0]
    img = (img - img.amin((1, 2), True)) / (img.amax((1, 2), True)
                                            - img.amin((1, 2), True))
    a = torch.tensor(0.08)
    theta = torch.tensor([[torch.cos(a), -torch.sin(a), 0.05],
                          [torch.sin(a), torch.cos(a), -0.03]])
    grid = torch.nn.functional.affine_grid(theta.expand(B, 2, 3),
                                           (B, 1, H, W), align_corners=False)
    img2 = torch.nn.functional.grid_sample(img[:B, None], grid,
                                           align_corners=False)[:, 0]
    return img[:B].contiguous(), img2.contiguous()


@pytest.fixture(scope="module")
def params():
    """Both networks' parameters as the reference draws them (every
    weight, bias and norm term nonzero): {"sp": ..., "lg": ...}."""
    g = torch.Generator().manual_seed(18)
    return {"sp": ref.random_params(ref.superpoint_shapes(), g),
            "lg": ref.random_params(ref.lightglue_shapes(256, 64, 2, HEADS),
                                    g)}


@pytest.fixture(scope="module")
def nets(params):
    """The program's networks with `params` loaded (copies: a fault
    planted in the program leaves the reference's parameters as drawn)."""
    sp_net = SuperPointNet()
    sp_net.load_state_dict(params["sp"])
    lg_net = LightGlueNet(input_dim=256, dim=64, n_layers=2, heads=HEADS)
    lg_net.load_state_dict(params["lg"])
    sp = SuperPoint(sp_net.eval(), max_features=K, keypoint_threshold=0.0005,
                    nms_radius=4)
    lg = LightGlue(lg_net.eval(), dim=64, n_layers=2, heads=HEADS,
                   input_dim=256)
    return sp, lg


@pytest.fixture(scope="module")
def step(params, nets):
    img1, img2 = _photos(5)
    out = make_deep_pair_fn(*nets, num_hypotheses=64,
                            filter_threshold=0.0)(img1, img2)
    with ref.precision("float32", "cpu"):
        feats = [ref.superpoint(params["sp"], im, K, 0.0005, 4)
                 for im in torch.cat([img1, img2])]
    return img1, img2, out, feats


def _same_keypoints(xy, scores, rxy, rscores):
    """Indices into both sides' keypoints at the pixels they share, after
    checking that every pixel one side alone has is a near-tie at the
    budget's last score."""
    key = (xy[:, 1] * W + xy[:, 0]).long()
    rkey = (rxy[:, 1] * W + rxy[:, 0]).long()
    inr, inp = torch.isin(key, rkey), torch.isin(rkey, key)
    cut = float(rscores.min())
    for alone in (scores[~inr], rscores[~inp]):
        assert all(abs(float(v) - cut) <= SCORE_TOL for v in alone)
    return (inr.nonzero()[:, 0][key[inr].argsort()],
            inp.nonzero()[:, 0][rkey[inp].argsort()])


@pytest.mark.parametrize("i", range(2 * B))
def test_superpoint_matches_reference(step, i):
    _, _, out, feats = step
    m = out["keypoint_mask"][i]
    xy, s, d = (out[k][i][m] for k in ("keypoints", "scores", "descriptors"))
    rxy, rs, rd = feats[i]
    assert len(rxy) == K and int(m.sum()) == K   # the budget fills
    ip, ir = _same_keypoints(xy, s, rxy, rs)
    assert len(ip) >= K - 2
    assert (s[ip] - rs[ir]).abs().max() <= SCORE_TOL
    assert (1 - (d[ip] * rd[ir]).sum(-1)).abs().max() <= DESC_TOL


def _lg_gaps(params, nets, f0, f1, size0, size1):
    """Largest gaps of the program's LightGlue against the reference on
    the valid keypoints of padded Features f0, f1: (log-assignment, z)."""
    lg = nets[1]
    norm = [tlg.normalize_keypoints(f.xy, *s) for f, s in ((f0, size0),
                                                             (f1, size1))]
    la, _, z0, z1 = lg.forward(f0.desc[None], f1.desc[None], norm[0][None],
                               norm[1][None], f0.mask[None], f1.mask[None])
    m0, m1 = f0.mask, f1.mask
    with ref.precision("float32", "cpu"):
        rla, rz0, rz1 = ref.lightglue(params["lg"], f0.desc[m0],
                                      f1.desc[m1], f0.xy[m0], f1.xy[m1],
                                      size0, size1, HEADS)
    gap = (la[0][m0][:, m1] - rla).abs().max()
    zgap = max((z0[0][m0] - rz0).abs().max(), (z1[0][m1] - rz1).abs().max())
    return float(gap), float(zgap)


def _features(out, i, mask=None):
    m = out["keypoint_mask"][i] if mask is None else mask
    return Features(xy=out["keypoints"][i], response=out["scores"][i],
                    scale=out["scores"][i], angle=out["scores"][i],
                    desc=out["descriptors"][i], mask=m)


@pytest.mark.parametrize("b", range(B))
def test_lightglue_matches_reference(params, nets, step, b):
    _, _, out, _ = step
    gap, zgap = _lg_gaps(params, nets, _features(out, b), _features(out, B + b),
                         SIZE, SIZE)
    assert gap <= LG_TOL and zgap <= Z_TOL


def test_lightglue_view_with_fewer_valid_keypoints(params, nets, step):
    """The second view keeps 40 of its 64 slots, the rest filled with
    noise: the program on the padded pair equals the reference on the 40
    valid keypoints alone."""
    _, _, out, _ = step
    g = torch.Generator().manual_seed(7)
    keep = torch.zeros(K, dtype=torch.bool)
    keep[torch.randperm(K, generator=g)[:40]] = True
    f1 = _features(out, B, keep)
    f1 = f1.replace(desc=torch.where(keep[:, None], f1.desc,
                                     torch.randn(K, 256, generator=g)),
                    xy=torch.where(keep[:, None], f1.xy,
                                   100 * torch.rand(K, 2, generator=g)))
    gap, zgap = _lg_gaps(params, nets, _features(out, 0), f1, SIZE, SIZE)
    assert gap <= LG_TOL and zgap <= Z_TOL


def _chain(params, feats, filter_threshold):
    """The reference's matches on its own features, through the
    program's RANSAC (held to its own plain copy elsewhere) with the
    step's uniforms: (num_matches, num_inliers, homography)."""
    plg = params["lg"]
    pts1, pts2 = torch.zeros(B, K, 2), torch.zeros(B, K, 2)
    ok = torch.zeros(B, K, dtype=torch.bool)
    with ref.precision("float32", "cpu"):
        for b in range(B):
            f0, f1 = feats[b], feats[B + b]
            la, _, _ = ref.lightglue(plg, f0[2], f1[2], f0[0], f1[0], SIZE,
                                     SIZE, HEADS)
            i0, i1 = ref.mutual_matches(la, filter_threshold)
            pts1[b, i0], pts2[b, i0], ok[b, i0] = f0[0][i0], f1[0][i1], True
    u = draw_uniform(64, 4, torch.Generator().manual_seed(0), "cpu")
    rr = find_homography(pts1, pts2, mask=ok, num_hypotheses=64, refit=False,
                         u=u)
    return ok.sum(-1, dtype=torch.int32), rr.num_inliers, rr.model


@pytest.mark.parametrize("filter_threshold", [0.0, 0.1])
def test_deep_step_matches_reference_chain(params, nets, step,
                                           filter_threshold):
    img1, img2, _, feats = step
    out = make_deep_pair_fn(*nets, num_hypotheses=64,
                            filter_threshold=filter_threshold)(img1, img2)
    nm, ni, Hm = _chain(params, feats, filter_threshold)
    assert torch.equal(out["num_matches"], nm)
    assert torch.equal(out["num_inliers"], ni)
    # a homography is an estimate only where RANSAC kept a model (4 or
    # more inliers); elsewhere it is the solve of a degenerate sample
    fit = ni >= 4
    torch.testing.assert_close(out["homography"][fit], Hm[fit], rtol=1e-4,
                               atol=1e-4)
    assert torch.isfinite(out["homography"]).all()
    assert out["inlier_ratio"].shape == (B,)
    if filter_threshold == 0.0:
        assert int(nm.min()) > 0          # mutual matches exist to compare
    assert out["assign_row_max"].shape == out["z0"].shape == (B, K)
    assert out["keypoints"].shape == (2 * B, K, 2)


def test_deep_ransac_gathers_the_matched_keypoints():
    """`deep_ransac` with the second view's keypoints in shuffled slots and
    best1 pointing at each match's slot: 32 true matches of a known
    homography and 16 outliers give what `find_homography` gives on the
    matches in order, and the homography is recovered."""
    g = torch.Generator().manual_seed(4)
    n = 48
    truth = torch.tensor([[1.02, -0.05, 3.0], [0.04, 0.98, -2.0],
                          [1e-4, 0.0, 1.0]])
    x1 = torch.rand(B, n, 2, generator=g) * torch.tensor([W - 1.0, H - 1.0])
    p = torch.cat([x1, torch.ones(B, n, 1)], -1) @ truth.T
    x2 = p[..., :2] / p[..., 2:]
    x2[:, 32:] = torch.rand(B, n - 32, 2, generator=g) * torch.tensor(
        [W - 1.0, H - 1.0])
    perm = torch.stack([torch.randperm(n, generator=g) for _ in range(B)])
    xy = torch.cat([x1, torch.zeros_like(x2)])
    xy[B:].scatter_(1, perm[..., None].expand(-1, -1, 2), x2)
    ok = torch.ones(B, n, dtype=torch.bool)
    out = deep_ransac(xy, perm, ok, 64)
    u = draw_uniform(64, 4, torch.Generator().manual_seed(0), "cpu")
    rr = find_homography(x1, x2, mask=ok, num_hypotheses=64, refit=False, u=u)
    assert torch.equal(out["num_inliers"], rr.num_inliers)
    assert (out["num_inliers"] >= 32).all()
    torch.testing.assert_close(out["homography"], rr.model)
    corners = torch.tensor([[0.0, 0.0, 1.0], [W - 1.0, H - 1.0, 1.0]]).T
    for Hb in out["homography"]:
        a, b = Hb @ corners, truth @ corners
        assert (a[:2] / a[2:] - b[:2] / b[2:]).abs().max() < 0.1


def test_keypoints_normalised_by_their_own_size(nets, monkeypatch):
    """768x1024 images: LightGlue sees keypoints centred on (512, 384) and
    scaled by 512, not by the (480, 640) fallback of `LightGlue.match`."""
    seen = []

    class Stub:
        def extract(self, image):
            n = image.shape[0]
            xy = torch.tensor([[0.0, 0.0], [1023.0, 767.0], [512.0, 384.0]])
            return Features(
                xy=xy.expand(n, 3, 2), response=torch.full((n, 3), 0.5),
                scale=torch.ones(n, 3), angle=torch.zeros(n, 3),
                desc=torch.nn.functional.normalize(torch.ones(n, 3, 256), dim=-1),
                mask=torch.ones(n, 3, dtype=torch.bool),
                image_shape=tuple(image.shape[-2:]))

    lg = nets[1]
    real = lg.forward

    def spy(desc0, desc1, xy0, xy1, mask0, mask1):
        seen.append(xy0)
        return real(desc0, desc1, xy0, xy1, mask0, mask1)

    monkeypatch.setattr(lg, "forward", spy)
    img = torch.zeros(1, 768, 1024)
    make_deep_pair_fn(Stub(), lg, num_hypotheses=8)(img, img)
    want = torch.tensor([[-1.0, -0.75], [511 / 512, 383 / 512], [0.0, 0.0]])
    torch.testing.assert_close(seen[0][0], want)


def _rotate_half_split(x):
    """The fault: rotary pairs laid out as two halves, not interleaved."""
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def _cross_wrong_axis(self, x0, x1, mask0, mask1):
    """The fault: the cross block's second softmax taken along view 1's
    axis (the first one's, transposed) instead of view 0's."""
    Bn, h = x0.shape[0], self.heads
    dh = self.dim // h
    qk0 = self.to_qk(x0).reshape(Bn, -1, h, dh) * dh ** -0.25
    qk1 = self.to_qk(x1).reshape(Bn, -1, h, dh) * dh ** -0.25
    v0 = self.to_v(x0).reshape(Bn, -1, h, dh)
    v1 = self.to_v(x1).reshape(Bn, -1, h, dh)
    sim = torch.einsum("bnhd,bmhd->bhnm", qk0, qk1)
    att01 = torch.softmax(sim.masked_fill(~mask1[:, None, None, :], -1e9), -1)
    att10 = att01.transpose(-1, -2)
    m0 = torch.einsum("bhnm,bmhd->bnhd", att01, v1).reshape(Bn, -1, self.dim)
    m1 = torch.einsum("bhmn,bnhd->bmhd", att10, v0).reshape(Bn, -1, self.dim)
    m0, m1 = self.to_out(m0), self.to_out(m1)
    return (x0 + self.ffn(torch.cat([x0, m0], dim=-1)),
            x1 + self.ffn(torch.cat([x1, m1], dim=-1)))


@pytest.mark.parametrize("fault", ["rotary_halves", "cross_softmax_axis",
                                   "dropped_bias"])
def test_planted_fault_fails_the_comparison(params, nets, step, fault,
                                            monkeypatch):
    if fault == "rotary_halves":
        monkeypatch.setattr(tlg, "rotate_half", _rotate_half_split)
    elif fault == "cross_softmax_axis":
        monkeypatch.setattr(tlg.CrossBlock, "forward", _cross_wrong_axis)
    else:
        # the program drops the first self block's Wqkv bias
        bias = nets[1].net.transformers[0].self_attn.Wqkv.bias
        monkeypatch.setattr(bias, "data", torch.zeros_like(bias))
    _, _, out, _ = step
    gap, _ = _lg_gaps(params, nets, _features(out, 0), _features(out, B), SIZE, SIZE)
    assert gap > 100 * LG_TOL


def _functions(path):
    tree = ast.parse(open(path).read())
    return {n.name: ast.dump(n) for n in tree.body
            if isinstance(n, ast.FunctionDef)}


def test_benchmark_copy_has_the_same_functions():
    """`recbench/reference/deep.py` holds every function of this reference
    with the same source, so the benchmark's yardstick cannot drift from
    what these tests hold the program to."""
    mine = _functions(ref.__file__)
    frozen = _functions(os.path.join(ROOT, "recbench", "reference",
                                     "deep.py"))
    assert mine and {k: frozen.get(k) for k in mine} == mine


def test_reference_imports_nothing_of_the_program():
    tops = set()
    for node in ast.walk(ast.parse(open(ref.__file__).read())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add((node.module or "").split(".")[0])
    assert tops <= {"__future__", "contextlib", "math", "torch"}, tops


def test_reference_precision_sets_and_restores_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with ref.precision("float32", "cpu"):
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        with ref.precision("bfloat16", "cpu"):
            assert torch.backends.cuda.matmul.allow_tf32
            assert torch.get_autocast_dtype("cpu") == torch.bfloat16
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        with pytest.raises(ValueError):
            with ref.precision("float16", "cpu"):
                pass
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_spans_and_counters(nets, step):
    """Under a profiler the step opens its three stages' spans and, inside
    them, the models' spans; it counts the host constants it uploads (the
    RANSAC threshold, one a batch)."""
    img1, img2, _, _ = step
    fn = make_deep_pair_fn(*nets, num_hypotheses=16)
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(img1, img2)
    names = {e.name for e in prof.events()}
    assert {"pair_step.detect", "pair_step.match", "pair_step.ransac",
            "superpoint.encoder", "superpoint.heads", "superpoint.select",
            "lightglue.embed", "lightglue.self", "lightglue.cross",
            "lightglue.assign"} <= names
    after = profiling.counters()
    assert after["upload.copies"] - before.get("upload.copies", 0) >= 1
