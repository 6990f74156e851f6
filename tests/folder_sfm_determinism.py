"""Where the card's SfM on chip_smoke.py's folder chain leaves the CPU's.

    CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 tests/folder_sfm_determinism.py [out.json]

Needs one CUDA card. Renders phase 7's folder (`chip_smoke.render_splat_views`:
24 views of 640x480, 600 splats, f = 544), matches it once on the card at
the `balanced` preset with the chain's settings (consecutive pairs, window
2, no homography filtering), then runs `SfMPipeline(SfMConfig()).reconstruct`
on those same matches twice on the card and once on the CPU, all with
`torch.use_deterministic_algorithms(True, warn_only=True)`. Each run's
view decisions are recorded in order: the init pair, then per view the
name, the PnP result (success, inliers, mean error), the incremental BA's
cost before and after, and whether the view was accepted. Prints the
nondeterministic ops torch warned about, each run's decisions, the first
decision (the init pair, the view order, accepted or not) where the two
card runs differ and where the card and the CPU differ, the first record
of any kind (a PnP count or error, a BA cost) where they differ, and each
run's rotation bars and largest camera rotation difference; then the
init pair's essential RANSAC as the CPU run called it, its inputs
against the card run's, replayed on both devices from the CPU run's
inputs, and on the card once more from the CPU's 5-point null-space
basis (`init_replay`). Not a test: pytest does not
collect it.
"""
import copy
import json
import os
import sys
import tempfile
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def run_logged(torch, tv, sp, matches_data, image_info, device):
    """One reconstruct on `device`; returns (recon, view decisions, the
    PnP and BA records in call order, the first `find_essential`
    call)."""
    log = []
    pnp_entry, ba_entry = sp.solve_pnp_ransac, sp.SfMPipeline._run_ba

    def pnp_spy(*a, **k):
        res = pnp_entry(*a, **k)
        f = res.packed.cpu().numpy()
        log.append({"pnp": [bool(f[0] > 0.5), int(f[1]), float(f[3])],
                    "n": int(a[1].shape[0])})
        return res

    def ba_spy(self, recon, *a, **k):
        out = ba_entry(self, recon, *a, **k)
        log.append({"ba": [float(out.get("initial_mean_reproj_px", -1.0)),
                           float(out.get("mean_reproj_px", -1.0)),
                           int(out.get("iterations", 0))],
                    "cams": recon.num_cameras})
        return out

    first, restore = spy_first_calls(torch, [(sp, "find_essential")])
    sp.solve_pnp_ransac, sp.SfMPipeline._run_ba = pnp_spy, ba_spy
    try:
        pipe = tv.SfMPipeline(tv.SfMConfig(), device=device)
        recon = pipe.reconstruct(copy.deepcopy(matches_data), image_info)
    finally:
        sp.solve_pnp_ransac, sp.SfMPipeline._run_ba = pnp_entry, ba_entry
        restore()
    decisions = []
    for h in pipe.history:
        if h["phase"] == "init":
            decisions.append({"init": list(h["pair"]),
                              "essential_inliers": h["essential_inliers"],
                              "points": h["points_initial"]})
        elif h["phase"] == "add_view":
            decisions.append({"view": h["image"], "accepted": h["success"],
                              "ba_mre0": round(h.get("ba_mre0", -1.0), 6),
                              "ba_mre": round(h.get("ba_mre", -1.0), 6)})
    return recon, decisions, log, first


def _host(x):
    """A call's argument or result with every tensor moved to the CPU."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, (list, tuple)):
        out = [_host(v) for v in x]
        return type(x)(*out) if hasattr(x, "_fields") else type(x)(out)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if hasattr(x, "__dataclass_fields__"):
        import dataclasses
        return dataclasses.replace(x, **{f: _host(getattr(x, f)) for f in
                                         x.__dataclass_fields__})
    return x


def _on(x, device):
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_on(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _on(v, device) for k, v in x.items()}
    return x


def spy_first_calls(torch, modules):
    """Record the first call of each (module, function name): its
    arguments and result, on the host. Returns (records, restore)."""
    rec, saved = {}, []
    for mod, name in modules:
        entry = getattr(mod, name)

        def spy(*a, _entry=entry, _name=name, **k):
            out = _entry(*a, **k)
            if _name not in rec:
                rec[_name] = (_host(a), _host(k), _host(out))
            return out
        saved.append((mod, name, entry))
        setattr(mod, name, spy)

    def restore():
        for mod, name, entry in saved:
            setattr(mod, name, entry)
    return rec, restore


def _unit(E):
    """E scaled to unit norm, its largest entry positive (E is defined up
    to scale and sign)."""
    E = E.double().reshape(3, 3)
    E = E / E.norm()
    return E if float(E.flatten()[E.abs().argmax()]) >= 0 else -E


def init_replay(torch, runs, dev, cpu):
    """The init pair's `find_essential` as the CPU run called it: its
    inputs against the card run's, then replayed from the CPU run's
    inputs on both devices (equal inputs), with the RANSAC stage's best
    model on each and both models scored on the full set in float64 on
    the host; then on the card from the CPU's 5-point null-space basis."""
    from tpu3drec_torch.ops import epipolar as ep
    ea, eka, eoa = runs["cpu"][3]["find_essential"]
    ec, ekc, eoc = runs["card_1"][3]["find_essential"]
    out = {"inputs_max_abs_diff_card_run_vs_cpu_run": [
        float((x.double() - y.double()).abs().max()) if hasattr(x, "double")
        else None for x, y in zip(ea, ec)],
        "kwargs_equal": all(
            (torch.equal(eka[k], ekc[k]) if hasattr(eka[k], "shape")
             else eka[k] == ekc[k]) for k in eka),
        "run_inliers": {"cpu": int(eoa.num_inliers), "card": int(eoc.num_inliers)}}
    from tpu3drec_torch.ops import five_point as fp
    rep = {}
    for label, d in (("cpu", cpu), ("card", dev), ("card_cpu_basis", dev)):
        spied = [(ep, "ransac")] + ([(fp, "null_basis")] if label == "cpu" else [])
        rec, restore = spy_first_calls(torch, spied)
        basis_entry = fp.null_basis
        if label == "card_cpu_basis":
            # the card's solver from the CPU's null-space basis (LAPACK
            # and cuSOLVER pick different bases of the same space)
            fp.null_basis = lambda x1, x2: cpu_basis.to(x1.device)
        try:
            got = ep.find_essential(*_on(ea, d), **_on(eka, d))
        finally:
            restore()
            fp.null_basis = basis_entry
        if label == "cpu":
            cpu_basis = rec["null_basis"][2]
        rep[label] = (rec["ransac"][2], _host(got))
    p1, p2, K1, K2 = (t.double() for t in ea[:4])
    p1n, p2n = ep.normalize_with_K(p1, K1), ep.normalize_with_K(p2, K2)
    f_mean = 0.25 * (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1])
    thr2 = float((eka.get("threshold_px", 1.5) / f_mean) ** 2)

    def score(E):
        r = ep.sampson_error(E.double()[None], p1n[None], p2n[None])[0]
        return int((r <= thr2).sum()), r

    for stage, pick, other in (("ransac", lambda v: v[0].model[0], "card"),
                               ("final", lambda v: v[1].E, "card"),
                               ("final", lambda v: v[1].E, "card_cpu_basis")):
        Ea, Eb = pick(rep["cpu"]), pick(rep[other])
        na, ra = score(Ea)
        nb, rb = score(Eb)
        flip = ((ra <= thr2) != (rb <= thr2)).nonzero()[:, 0]
        out[f"replay_{stage}_cpu_vs_{other}"] = {
            "E_rel_diff": float((_unit(Ea) - _unit(Eb)).abs().max()),
            "float64_inliers_of_cpu_model": na,
            f"float64_inliers_of_{other}_model": nb,
            "flipped_points_residual_over_thr": [
                [round(float(ra[i]) / thr2, 4), round(float(rb[i]) / thr2, 4)]
                for i in flip[:12]]}
    out["replay_inliers"] = {k: int(v[1].num_inliers) for k, v in rep.items()}
    out["replay_ransac_inliers"] = {k: int(v[0].num_inliers[0])
                                    for k, v in rep.items()}
    return out


def first_difference(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, x, y
    if len(a) != len(b):
        n = min(len(a), len(b))
        return n, (a[n:] or None), (b[n:] or None)
    return None


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.use_deterministic_algorithms(True, warn_only=True)
    import chip_smoke as cs
    import tpu3drec_torch as tv
    import tpu3drec_torch.sfm.pipeline as sp
    from tpu3drec_torch import _nvcc

    _nvcc.build()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    out = {"card": cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}
    with tempfile.TemporaryDirectory(prefix="sfm_det_") as tmp:
        folder = os.path.join(tmp, "imgs")
        os.mkdir(folder)
        names, Rs = cs.render_splat_views(folder, cs.FOLDER_VIEWS,
                                          cs.FOLDER_POINTS)
        pipe = tv.create_pipeline("balanced", {
            "filtering": {"use_adaptive_filtering": False}}, device=dev)
        t0 = time.perf_counter()
        summary = pipe.match_folder(folder, os.path.join(tmp, "m"),
                                    pair_mode="consecutive",
                                    pair_window=cs.FOLDER_PAIR_WINDOW,
                                    collect_results=True)
        out["matching_s"] = round(time.perf_counter() - t0, 3)
    md, info = summary["matches_data"], summary["image_info"]

    runs = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for label, d in (("card_1", dev), ("card_2", dev), ("cpu", cpu)):
            t0 = time.perf_counter()
            recon, dec, log, first = run_logged(torch, tv, sp, md, info, d)
            rot = cs.consecutive_rotation_errors(recon, Rs, names)
            runs[label] = (recon, dec, log, first)
            out[label] = {
                "seconds": round(time.perf_counter() - t0, 3),
                "views": recon.num_cameras, "points": recon.num_points,
                "missing": sorted(set(names) - set(recon.cameras)),
                "rotation_median_deg": float(np.median(rot)),
                "share_within_1deg": float(np.mean(rot < 1.0)),
                "rotation_errors_deg": [round(float(r), 3) for r in rot],
                "decisions": dec, "pnp_and_ba": log}
    out["nondeterministic_ops_warned"] = sorted(
        {str(w.message)[:300] for w in caught})
    out["init_replay"] = init_replay(torch, runs, dev, cpu)
    for label, run in runs.items():
        out[label]["choices"] = [
            {k: v for k, v in d.items() if k in ("init", "view", "accepted")}
            for d in run[1]]
    for a, b in (("card_1", "card_2"), ("card_1", "cpu")):
        for key in ("choices", "decisions", "pnp_and_ba"):
            d = first_difference(out[a][key], out[b][key])
            out[f"first_difference_{key}_{a}_vs_{b}"] = (
                None if d is None else {"index": d[0], a: d[1], b: d[2]})
        ra, rb = runs[a][0], runs[b][0]
        common = [n for n in names if n in ra.cameras and n in rb.cameras]
        out[f"max_rotation_deg_{a}_vs_{b}"] = max(
            (cs.rot_err_deg(ra.cameras[n].R, rb.cameras[n].R) for n in common),
            default=None)
    if len(sys.argv) > 1:          # the whole record, as JSON
        os.makedirs(os.path.dirname(os.path.abspath(sys.argv[1])),
                    exist_ok=True)
        with open(sys.argv[1], "w") as f:
            json.dump(out, f, indent=1, default=float)
    for k, v in out.items():
        if k.startswith(("card_", "cpu")):
            print(k, {kk: vv for kk, vv in v.items()
                      if kk not in ("choices", "decisions", "pnp_and_ba")})
        else:
            print(k, json.dumps(v, default=float)[:2000])


if __name__ == "__main__":
    main()
