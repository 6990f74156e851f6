"""ALIKED-n16 and the deep pair step with ALIKED + LightGlue
(`tpu3drec_torch.pair_step.make_deep_pair_fn(ALIKEDN16, LightGlue)`)
against the plain references `tests/plain_aliked.py` and
`tests/plain_superpoint_lightglue.py`, on random parameters that the
references draw (every weight, bias and BatchNorm term nonzero) and the
program loads, at small sizes on the CPU: 2 images (2 pairs) of 96x128,
ALIKED keeping 64 keypoints above 0.2, LightGlue at 128-d input, width
64, 4 heads and 2 layers.

Both sides compute in float32 and in different forms (matrix products
against `F.interpolate`, gathers against `grid_sample`, one dense layer
against a K x K convolution), so the bars sit ten or more times above
what they differ by (observed gaps in brackets): the score map within
SCORE_TOL (6.6e-7, kept scores of 0.69-0.88), the normalised map within
MAP_TOL (3.9e-7 on unit vectors of 128 entries), DKD positions within
XY_TOL (7.6e-6 px; a position moves by d score / 0.1 of the window's
weights), descriptors within DESC_TOL of 1 - cos (1.4e-7, a float32 dot
product of unit vectors), LightGlue's log-assignment maxima within LG_TOL and
its matchability within Z_TOL (as `test_torch_deep_pair_step.py`).
Keypoints are the same peaks but for ties within SCORE_TOL. Planted
faults put the gaps 100 times or more above the bars.

Tests marked `card` run the step on a CUDA card at the published size
(`python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_aliked_lightglue.py`; the card's machine has no JAX)
and skip without one.
"""

import ast
import inspect
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_threads import torch_threads  # noqa: F401  (autouse)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import plain_aliked as ref  # noqa: E402
import plain_superpoint_lightglue as lgref  # noqa: E402
from tpu3drec_torch.models import aliked_n16 as tn16  # noqa: E402
from tpu3drec_torch.models._common import (  # noqa: E402
    local_peaks, top_k_pixels,
)
from tpu3drec_torch.models.lightglue import (  # noqa: E402
    LightGlue, LightGlueNet,
)
from tpu3drec_torch.ops.geometry import find_homography  # noqa: E402
from tpu3drec_torch.ops.ransac import draw_uniform  # noqa: E402
from tpu3drec_torch.pair_step import make_deep_pair_fn  # noqa: E402
from tpu3drec_torch.utils import profiling  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, K, B = 96, 128, 64, 2
THRESHOLD, RADIUS = 0.2, 2
HEADS, LG_DIM, LG_LAYERS = 4, 64, 2
SIZE = (H, W)
SCORE_TOL = 1e-5
MAP_TOL = 1e-5
XY_TOL = 2e-4
DESC_TOL = 2e-6
LG_TOL = 2e-4
Z_TOL = 2e-5


def _photos(seed, h=H, w=W, n=2 * B):
    """Band-limited noise photos, the second half of each batch a small
    rotation and shift of the first."""
    g = torch.Generator().manual_seed(seed)
    img = torch.zeros(n, 1, h, w)
    for s in (4, 8, 16):
        img += torch.nn.functional.interpolate(
            torch.rand(n, 1, h // s + 1, w // s + 1, generator=g),
            size=(h, w), mode="bicubic", align_corners=False)
    img = img[:, 0]
    img = (img - img.amin((1, 2), True)) / (img.amax((1, 2), True)
                                            - img.amin((1, 2), True))
    a = torch.tensor(0.08)
    theta = torch.tensor([[torch.cos(a), -torch.sin(a), 0.05],
                          [torch.sin(a), torch.cos(a), -0.03]])
    half = n // 2
    grid = torch.nn.functional.affine_grid(theta.expand(half, 2, 3),
                                           (half, 1, h, w),
                                           align_corners=False)
    img2 = torch.nn.functional.grid_sample(img[:half, None], grid,
                                           align_corners=False)[:, 0]
    return img[:half].contiguous(), img2.contiguous()


def _load(net, params):
    missing, unexpected = net.load_state_dict(params, strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing)
    return net.eval()


@pytest.fixture(scope="module")
def params():
    """Both networks' parameters as the references draw them."""
    g = torch.Generator().manual_seed(22)
    return {"al": ref.aliked_params(g),
            "lg": lgref.random_params(
                lgref.lightglue_shapes(128, LG_DIM, LG_LAYERS, HEADS), g)}


@pytest.fixture(scope="module")
def nets(params):
    """The program's wrappers with `params` loaded (copies: a fault
    planted in the program leaves the references' parameters as drawn)."""
    al = tn16.ALIKEDN16(_load(tn16.ALIKEDN16Net(), params["al"]),
                        max_features=K, nms_radius=RADIUS, threshold=THRESHOLD)
    lg_net = LightGlueNet(input_dim=128, dim=LG_DIM, n_layers=LG_LAYERS,
                          heads=HEADS)
    lg_net.load_state_dict(params["lg"])
    lg = LightGlue(lg_net.eval(), dim=LG_DIM, n_layers=LG_LAYERS, heads=HEADS,
                   input_dim=128)
    return al, lg


@pytest.fixture(scope="module")
def images():
    img1, img2 = _photos(5)
    return torch.cat([img1, img2])


@pytest.fixture(scope="module")
def reference(params, images):
    """The plain reference's features of each image: (xy, scores, desc,
    peaks, offsets at the clamp)."""
    with ref.precision("float32", "cpu"):
        return [ref.aliked(params["al"], im, K, THRESHOLD, RADIUS)
                for im in images]


def _program_peaks(al, images):
    """The program's maps and the integer peaks its top-k keeps, from its
    own forward: (score, feat, vals, xs, ys)."""
    with torch.no_grad():
        score, feat = al.net(images[..., None].expand(-1, -1, -1, 3))
        vals, xs, ys = top_k_pixels(local_peaks(score, RADIUS, -float("inf")),
                                    K)
    return score, feat, vals, xs.long(), ys.long()


def test_reference_names_fit_the_program(params):
    net = tn16.ALIKEDN16Net()
    state = {k: v for k, v in net.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    shapes = ref.aliked_shapes()
    assert [n for n, _ in shapes] == list(state)
    assert all(tuple(state[n].shape) == s for n, s in shapes)
    p = params["al"]
    assert all((v != 0).all() for v in p.values())
    assert all((p[n] > 0).all() for n in p if n.endswith("running_var"))
    # 677,837 parameters and 960 BatchNorm statistics
    assert sum(x.numel() for x in net.parameters()) == 677_837


@pytest.mark.parametrize("i", range(2 * B))
def test_maps_match_reference(params, nets, images, i):
    """The lean forward's score map and normalised map (one buffer,
    written a slice of images at a time) against the plain forward."""
    score, feat, *_ = _program_peaks(nets[0], images)
    with ref.precision("float32", "cpu"):
        rscore, rfeat, _ = ref.aliked_maps(params["al"], images[i])
    assert feat.is_contiguous() and feat.shape == (2 * B, H, W, 128)
    assert (score[i] - rscore).abs().max() <= SCORE_TOL
    assert (feat[i] - rfeat.permute(1, 2, 0)).abs().max() <= MAP_TOL


def test_head_slices_give_the_one_batch_answer(nets, images, monkeypatch):
    """A map written one image at a time equals the one written whole."""
    whole = _program_peaks(nets[0], images)[:2]
    monkeypatch.setattr(tn16, "_HEAD_PIXELS", H * W)
    sliced = _program_peaks(nets[0], images)[:2]
    for a, b in zip(whole, sliced):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("i", range(2 * B))
def test_extract_matches_reference(nets, images, reference, i):
    """Keypoints, DKD positions, scores and SDDH descriptors of the
    step's extractor against the reference, on the peaks both keep."""
    f = nets[0].extract(images)
    _, _, vals, xs, ys = _program_peaks(nets[0], images)
    m = f.mask[i]
    rxy, rs, rd, rpk, _ = reference[i]
    assert int(m.sum()) == len(rxy) == K          # the budget fills
    key = (ys[i] * W + xs[i])[m]
    rkey = rpk[:, 1] * W + rpk[:, 0]
    inr, inp = torch.isin(key, rkey), torch.isin(rkey, key)
    cut = float(rs.min())
    for alone in (vals[i][m][~inr], rs[~inp]):
        assert all(abs(float(v) - cut) <= SCORE_TOL for v in alone)
    ip = inr.nonzero()[:, 0][key[inr].argsort()]
    ir = inp.nonzero()[:, 0][rkey[inp].argsort()]
    assert len(ip) >= K - 2
    assert (f.xy[i][m][ip] - rxy[ir]).abs().max() <= XY_TOL
    assert (f.response[i][m][ip] - rs[ir]).abs().max() <= SCORE_TOL
    cos = (f.desc[i][m][ip].double() * rd[ir].double()).sum(-1)
    assert (1 - cos).max() <= DESC_TOL


def test_padded_image_matches_reference(params, nets):
    """90x120 images, padded to 96x128 inside: the map keeps its padded
    rows and columns, and DKD and SDDH read it bounded at 90x120."""
    img = _photos(9, 90, 120, 2)[0]
    f = nets[0].extract(img)
    with ref.precision("float32", "cpu"):
        rxy, rs, rd, _, _ = ref.aliked(params["al"], img[0], K, THRESHOLD,
                                       RADIUS)
    m = f.mask[0]
    assert f.image_shape == (90, 120) and int(m.sum()) == len(rxy)
    near = (f.xy[0][m][:, None] - rxy[None]).abs().amax(-1)
    d, j = near.min(1)
    shared = d <= XY_TOL
    assert int(shared.sum()) >= len(rxy) - 2
    cos = (f.desc[0][m][shared].double() * rd[j[shared]].double()).sum(-1)
    assert (1 - cos).max() <= DESC_TOL


def test_sddh_samples_across_the_borders(params, nets, images):
    """Keypoints on and next to the image's edges, where SDDH's samples
    fall outside the map and read zero: the program's head against the
    reference's, on the same map."""
    net = nets[0].net
    with ref.precision("float32", "cpu"):
        _, rfeat, _ = ref.aliked_maps(params["al"], images[0])
    xy = torch.tensor([[0.0, 0.0], [W - 1.0, H - 1.0], [0.4, 50.2],
                       [127.0, 3.7], [64.5, 0.0], [20.2, 95.0]])
    with ref.precision("float32", "cpu"):
        rdesc, _ = ref.sddh(params["al"], rfeat, xy)
        # where the reference's samples lie: some outside the map
        d = torch.arange(-1, 2)
        xi = torch.round(xy[:, 0]).long().clamp(1, W - 2)
        yi = torch.round(xy[:, 1]).long().clamp(1, H - 2)
        patches = rfeat[:, (yi[:, None] + d)[:, :, None],
                        (xi[:, None] + d)[:, None, :]].permute(1, 0, 2, 3)
        o = torch.nn.functional.selu(ref.conv(params["al"], "sddh.off1",
                                              patches, 0))
        pos = xy[:, None] + ref.conv(params["al"], "sddh.off2", o,
                                     0).reshape(len(xy), -1, 2)
    outside = ((pos[..., 0] < 0) | (pos[..., 0] > W - 1) | (pos[..., 1] < 0)
               | (pos[..., 1] > H - 1))
    assert outside.any(1).sum() >= 4
    with torch.no_grad():
        desc = net.sddh(rfeat.permute(1, 2, 0)[None].contiguous(), xy[None])[0]
    cos = (desc.double() * rdesc.double()).sum(-1)
    assert (1 - cos).max() <= DESC_TOL


@pytest.fixture(scope="module")
def step(nets, images):
    return make_deep_pair_fn(*nets, num_hypotheses=64,
                             filter_threshold=0.0)(images[:B], images[B:])


@pytest.mark.parametrize("b", range(B))
def test_lightglue_on_the_programs_features(params, step, b):
    """LightGlue at 128-d input, in the step, against the reference run
    on the step's own keypoints and descriptors: the log-assignment's row
    and column maxima, the matchability logits, and the argmax of every
    row the reference decides by more than LG_TOL."""
    m0, m1 = step["keypoint_mask"][b], step["keypoint_mask"][B + b]
    xy0, xy1 = step["keypoints"][b][m0], step["keypoints"][B + b][m1]
    d0, d1 = step["descriptors"][b][m0], step["descriptors"][B + b][m1]
    with lgref.precision("float32", "cpu"):
        la, z0, z1 = lgref.lightglue(params["lg"], d0, d1, xy0, xy1, SIZE,
                                     SIZE, HEADS)
    assert (step["assign_row_max"][b][m0] - la.max(1).values).abs().max() \
        <= LG_TOL
    assert (step["assign_col_max"][b][m1] - la.max(0).values).abs().max() \
        <= LG_TOL
    assert (step["z0"][b][m0] - z0).abs().max() <= Z_TOL
    assert (step["z1"][b][m1] - z1).abs().max() <= Z_TOL
    top = la.topk(2, dim=1).values
    decided = top[:, 0] - top[:, 1] > LG_TOL
    assert decided.float().mean() > 0.5
    pos = m1.long().cumsum(0) - 1
    best1 = pos[step["best1"][b].long()][m0]
    assert torch.equal(best1[decided], la.argmax(1)[decided])


def _chain(params, reference, filter_threshold):
    """The reference's matches on its own features, through the program's
    RANSAC with the step's uniforms: (num_matches, num_inliers,
    homography)."""
    pts1, pts2 = torch.zeros(B, K, 2), torch.zeros(B, K, 2)
    ok = torch.zeros(B, K, dtype=torch.bool)
    with lgref.precision("float32", "cpu"):
        for b in range(B):
            f0, f1 = reference[b], reference[B + b]
            la, _, _ = lgref.lightglue(params["lg"], f0[2], f1[2], f0[0],
                                       f1[0], SIZE, SIZE, HEADS)
            i0, i1 = lgref.mutual_matches(la, filter_threshold)
            pts1[b, i0], pts2[b, i0], ok[b, i0] = f0[0][i0], f1[0][i1], True
    u = draw_uniform(64, 4, torch.Generator().manual_seed(0), "cpu")
    rr = find_homography(pts1, pts2, mask=ok, num_hypotheses=64, refit=False,
                         u=u)
    return ok.sum(-1, dtype=torch.int32), rr.num_inliers, rr.model


@pytest.mark.parametrize("filter_threshold", [0.0, 0.02])
def test_deep_step_matches_reference_chain(params, nets, images, reference,
                                           filter_threshold):
    out = make_deep_pair_fn(*nets, num_hypotheses=64,
                            filter_threshold=filter_threshold)(
        images[:B], images[B:])
    nm, ni, Hm = _chain(params, reference, filter_threshold)
    assert torch.equal(out["num_matches"], nm)
    assert torch.equal(out["num_inliers"], ni)
    fit = ni >= 4
    torch.testing.assert_close(out["homography"][fit], Hm[fit], rtol=1e-4,
                               atol=1e-4)
    if filter_threshold == 0.0:
        assert int(nm.min()) > 0          # mutual matches exist to compare
    assert out["descriptors"].shape == (2 * B, K, 128)


def test_the_step_takes_any_extractor():
    first = next(iter(inspect.signature(make_deep_pair_fn).parameters))
    assert first == "extractor"


def test_spans_and_counters(nets, images):
    """Under a profiler the step opens ALIKED's five spans inside
    `pair_step.detect` and counts its samples: B h w 9 taps for each of
    the four deformable convolutions (1/8 and 1/32), B N M for SDDH."""
    fn = make_deep_pair_fn(*nets, num_hypotheses=16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(images[:B], images[B:])
        got = profiling.counters(traced=True)
    names = [e.name for e in prof.events()]
    assert {"pair_step.detect", "aliked.backbone", "aliked.deform",
            "aliked.head", "aliked.select", "aliked.sddh",
            "lightglue.self", "lightglue.cross"} <= set(names)
    assert names.count("aliked.deform") == 4
    n = 2 * B
    assert got["aliked.deform.samples"] == 9 * n * 2 * (
        (H // 8) * (W // 8) + (H // 32) * (W // 32))
    assert got["aliked.sddh.samples"] == n * K * 16


def test_work_matches_a_hand_count():
    """7.87 GMAC of ALIKED-n16's dense network a 768x1024 image, and
    562,176 MAC of SDDH a keypoint, counted here by hand from the
    published widths; LightGlue's parameters at 128-d input are the
    program's module's."""
    from recbench.trace import aliked_work, deep_work
    hw = 768 * 1024
    hand = (hw * (3 * 16 * 9 + 16 * 16 * 9)                   # block1
            + hw // 4 * (16 * 32 * 9 + 32 * 32 * 9 + 16 * 32)  # block2
            + hw // 64 * (32 * 18 * 9 + 32 * 64 * 9 + 64 * 18 * 9
                          + 64 * 64 * 9 + 32 * 64)              # block3
            + hw // 1024 * (64 * 18 * 9 + 64 * 128 * 9 + 128 * 18 * 9
                            + 128 * 128 * 9 + 64 * 128)         # block4
            + hw * 16 * 32 + hw // 4 * 32 * 32 + hw // 64 * 64 * 32
            + hw // 1024 * 128 * 32                              # levels
            + hw * (128 * 8 + 8 * 4 * 9 + 4 * 4 * 9 + 4 * 9))   # score
    assert aliked_work.aliked_dense_macs(768, 1024) == hand
    assert hand == pytest.approx(7.87e9, abs=0.005e9)
    assert aliked_work.SDDH_MACS == 128 * 32 * 9 + 32 * 32 + 2 * 16 * 128 * 128
    assert deep_work.lightglue_params(256, 9, 4, 128) == sum(
        p.numel() for p in LightGlueNet(input_dim=128).parameters()) \
        == 11_354_177
    op = {"pairs": 32, "height": 768, "width": 1024, "valid": [2048] * 64,
          "dim": 256, "n_layers": 9, "heads": 4, "input_dim": 128}
    al, lg = aliked_work.batch_flops(op)
    assert al == 2 * 64 * (hand + 2048 * aliked_work.SDDH_MACS)
    assert al == pytest.approx(1.155e12, abs=0.001e12)
    # fewer valid keypoints, less SDDH work
    assert aliked_work.batch_flops(dict(op, valid=[1024] * 64))[0] < al


_REAL_EXTRACT = tn16.ALIKEDN16.extract


def _dkd_temperature_one(self, image):
    """The fault: DKD's soft-argmax at temperature 1 (exp(s) for exp(s /
    0.1)), through the real `extract` with `torch.exp` scaled."""
    real = torch.exp
    torch.exp = lambda x, *a, **kw: real(x * 0.1, *a, **kw)
    try:
        return _REAL_EXTRACT(self, image)
    finally:
        torch.exp = real


@pytest.mark.parametrize("fault", ["dkd_temperature", "no_zero_padding",
                                   "dropped_offset_bias"])
def test_planted_fault_fails_the_comparison(params, nets, images, reference,
                                            fault, monkeypatch):
    al = nets[0]
    if fault == "dkd_temperature":
        monkeypatch.setattr(tn16.ALIKEDN16, "extract", _dkd_temperature_one)
    elif fault == "no_zero_padding":
        # samples outside the map read its edge instead of zero
        real = tn16._bilinear_map
        monkeypatch.setattr(
            tn16, "_bilinear_map",
            lambda img, px, py, size=None: real(
                img, px.clamp(0, img.shape[2] - 1),
                py.clamp(0, img.shape[1] - 1), size))
    else:
        bias = al.net.block3.conv1.offset_conv.bias
        monkeypatch.setattr(bias, "data", torch.zeros_like(bias))
    f = al.extract(images)
    rxy, _, rd, _, _ = reference[0]
    m = f.mask[0]
    near = (f.xy[0][m][:, None] - rxy[None]).abs().amax(-1)
    d, j = near.min(1)
    cos = (f.desc[0][m].double() * rd[j].double()).sum(-1)
    assert float(d.max()) > 100 * XY_TOL or float((1 - cos).max()) \
        > 100 * DESC_TOL


def _statements(path):
    """The top-level statements of a module but its docstring and
    imports, as source."""
    text = open(path).read()
    tree = ast.parse(text)
    return [ast.get_source_segment(text, n) for n in tree.body
            if not isinstance(n, (ast.Import, ast.ImportFrom))
            and not (isinstance(n, ast.Expr)
                     and isinstance(n.value, ast.Constant))]


def test_benchmark_copy_has_the_same_statements():
    """`recbench/reference/aliked.py` holds every statement of this
    reference but its imports, with the same source, so the benchmark's
    yardstick cannot drift from what these tests hold the program to."""
    mine = _statements(ref.__file__)
    frozen = _statements(os.path.join(ROOT, "recbench", "reference",
                                      "aliked.py"))
    assert mine and frozen[:len(mine)] == mine


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
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        with ref.precision("tf32", "cpu"):
            assert torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cudnn.allow_tf32
        with ref.precision("float32", "cpu"):
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == (False, True)
        with pytest.raises(ValueError):
            with ref.precision("bfloat16", "cpu"):
                pass
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_the_forward_runs_in_full_float32(nets, images, monkeypatch):
    """Inside ALIKED's forward both TF32 flags are off, whatever the
    caller set, and are restored after."""
    seen = []
    real = tn16.ALIKEDN16Net.head

    def spy(self, levels):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return real(self, levels)

    monkeypatch.setattr(tn16.ALIKEDN16Net, "head", spy)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        nets[0].extract(images[:1])
        assert seen == [(False, False)]
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    """Skips where no CUDA card is present (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_nets(card, seed):
    g = torch.Generator().manual_seed(seed)
    p_al = ref.aliked_params(g)
    p_lg = lgref.random_params(lgref.lightglue_shapes(128, 256, 9, HEADS), g)
    al = tn16.ALIKEDN16(_load(tn16.ALIKEDN16Net(), p_al).to(card),
                        max_features=2048, nms_radius=RADIUS,
                        threshold=THRESHOLD)
    lg_net = LightGlueNet(input_dim=128)
    lg_net.load_state_dict(p_lg)
    lg = LightGlue(lg_net.to(card).eval(), input_dim=128)
    return al, lg, {k: v.to(card) for k, v in p_al.items()}, \
        {k: v.to(card) for k, v in p_lg.items()}


@pytest.mark.card
def test_card_step_at_the_published_size(card):
    """2 pairs of 768x1024 through the step on the card: every image's
    keypoints, DKD positions and descriptors against the plain reference
    on the card (float32 on both sides; bars ten times the CPU's), and
    LightGlue (TF32 inside the step) on the step's features against the
    float32 reference within the benchmark cell's limit of 0.18."""
    al, lg, p_al, p_lg = _card_nets(card, 31)
    img1, img2 = (x.to(card) for x in _photos(7, 768, 1024, 4))
    out = make_deep_pair_fn(al, lg)(img1, img2)
    images = torch.cat([img1, img2])
    for i in range(4):
        m = out["keypoint_mask"][i]
        with ref.precision("float32"):
            rxy, rs, rd, _, _ = ref.aliked(p_al, images[i], 2048, THRESHOLD,
                                           RADIUS)
        xy = out["keypoints"][i][m]
        assert int(m.sum()) == len(rxy) > 1000
        d, j = (xy[:, None] - rxy[None]).abs().amax(-1).min(1)
        shared = d <= 10 * XY_TOL
        assert int(shared.sum()) >= 0.99 * len(rxy)
        cos = (out["descriptors"][i][m][shared].double()
               * rd[j[shared]].double()).sum(-1)
        assert (1 - cos).max() <= 10 * DESC_TOL
    for b in range(2):
        m0, m1 = out["keypoint_mask"][b], out["keypoint_mask"][2 + b]
        with lgref.precision("float32"):
            la, _, _ = lgref.lightglue(
                p_lg, out["descriptors"][b][m0], out["descriptors"][2 + b][m1],
                out["keypoints"][b][m0], out["keypoints"][2 + b][m1],
                (768, 1024), (768, 1024), HEADS)
        assert (out["assign_row_max"][b][m0] - la.max(1).values).abs().max() \
            <= 0.18


@pytest.mark.card
def test_card_32_pairs_fit(card):
    """The benchmark cell's batch, 32 pairs of 768x1024 at 2,048
    keypoints, in one call, under 64 GB (80% of an H100's memory); the
    ALIKED forward alone holds one 128-channel map (25.8 GB) and its
    transients."""
    al, lg, _, _ = _card_nets(card, 32)
    img1, img2 = (x.to(card) for x in _photos(8, 768, 1024, 64))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = make_deep_pair_fn(al, lg)(img1, img2)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    assert out["keypoints"].shape == (64, 2048, 2)
    assert out["num_matches"].shape == (32,)
    assert torch.isfinite(out["homography"]).all()
    assert peak < 64e9, peak
