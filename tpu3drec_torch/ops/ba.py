"""Bundle adjustment: Levenberg-Marquardt with the Schur complement on
camera / point blocks and Huber IRLS.

Port of `tpu3drec/ops/ba.py`. The parameter layout is the reference's:
per camera [rvec(3), tvec(3), fx, fy, cx, cy], then 3 coordinates a
point. Per-observation Jacobians are forward-mode (`torch.func.jacfwd`
under `vmap`), so every `where` (the Taylor branch of `exp_so3`, the
behind-camera sentinel) takes the chosen branch's derivative, as
`jax.jacfwd` does. The normal equations are reduced to the cameras,

    [U  W] [dc]   [gc]            S dc = gc - W V^-1 gp,
    [W' V] [dp] = [gp]   =>       dp   = V^-1 (gp - W' dc),

and S is solved densely (W scattered over (P, C) blocks: the incremental
window of a few cameras) or by block-Jacobi preconditioned CG whose matvec
is O(M) scatter-adds (global BA, 50 cameras / 100k points / 500k
observations).

The reference's two data-dependent loops run as host loops over device
state. LM checks its stop flag on the host once an iteration (one sync).
CG runs in blocks of `CG_CHECK` iterations in which a device-side flag
(the reference's loop condition) freezes the state once it stops, and the
host reads that flag once a block: the arithmetic and the iteration
counts are the reference's, at up to CG_CHECK - 1 frozen iterations and
one sync a block. Segment sums are `index_add_` on the CPU, which adds
rows in order. On CUDA its float atomics add them in whatever order the
card runs them, so a solve's last bits, and through them which weak
views an incremental reconstruction registers, varied from run to run;
there the rows are summed in a fixed order instead (`_segments`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from tpu3drec_torch.core.device import resolve_device
from tpu3drec_torch.ops.lie import exp_so3

CAM_DIM = 10  # rvec(3) + tvec(3) + fx, fy, cx, cy
CG_CHECK = 8  # CG iterations between host reads of the stop flag
SEG_CHUNK = 256  # rows summed in order by one CUDA thread (`_segments`)


class BAProblem(NamedTuple):
    """Static-shape BA problem; padded observations are gated by
    `obs_mask`."""
    cam_params: torch.Tensor  # (C, 10)
    points: torch.Tensor      # (P, 3)
    obs_cam: torch.Tensor     # (M,) int camera index per observation
    obs_pt: torch.Tensor      # (M,) int point index per observation
    obs_uv: torch.Tensor      # (M, 2) measured pixels
    obs_mask: torch.Tensor    # (M,) bool
    param_mask: torch.Tensor  # (C, 10) float, 0 freezes a parameter
    point_mask: torch.Tensor  # (P,) bool, False freezes / ignores a point

    @classmethod
    def from_numpy(cls, cam_params, points, obs_cam, obs_pt, obs_uv,
                   obs_mask=None, param_mask=None, point_mask=None,
                   device=None) -> "BAProblem":
        """A problem on `device` (None means CUDA) from host arrays, e.g.
        the fields of the reference's BAProblem through `np.asarray`.
        Missing masks are all ones."""
        dev = resolve_device(device)
        cam_params = np.asarray(cam_params, np.float32)
        points = np.asarray(points, np.float32)
        m = len(obs_cam)
        obs_mask = np.ones(m, bool) if obs_mask is None else obs_mask
        param_mask = (np.ones(cam_params.shape, np.float32)
                      if param_mask is None else param_mask)
        point_mask = (np.ones(len(points), bool) if point_mask is None
                      else point_mask)
        t = lambda a, dt: torch.as_tensor(np.array(a, dt), device=dev)
        return cls(cam_params=t(cam_params, np.float32),
                   points=t(points, np.float32),
                   obs_cam=t(obs_cam, np.int64), obs_pt=t(obs_pt, np.int64),
                   obs_uv=t(obs_uv, np.float32), obs_mask=t(obs_mask, bool),
                   param_mask=t(param_mask, np.float32),
                   point_mask=t(point_mask, bool))

    def to_numpy(self) -> dict:
        """The fields as host arrays, keyed by the reference's names."""
        return {k: v.detach().cpu().numpy() for k, v in self._asdict().items()}


class BAConfig(NamedTuple):
    max_iters: int = 20
    huber_delta: float = 2.0
    lambda_init: float = 1e-3
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    ftol: float = 1e-6
    optimize_intrinsics: bool = True
    # "dense" (W as (P, C, 10, 3) blocks: the few-camera window), "cg"
    # (matrix-free Schur, block-Jacobi preconditioner) or "auto" (CG
    # above 32 cameras)
    schur_solver: str = "auto"
    cg_iters: int = 64
    cg_tol: float = 1e-5
    # 0 LM iterations when the initial masked mean reprojection is below
    # this many pixels; 0 disables the gate
    skip_if_below_px: float = 0.0


class BAResult(NamedTuple):
    cam_params: torch.Tensor
    points: torch.Tensor
    cost_initial: torch.Tensor
    cost_final: torch.Tensor
    iterations: torch.Tensor
    mean_reproj_px: torch.Tensor
    # (6,) [cost_initial, cost_final, iterations, mean_reproj_px,
    # final_lambda, initial_mean_reproj_px]: the reference's layout;
    # final_lambda warm-starts the next incremental solve
    stats: torch.Tensor
    # (C*10 + P*3 + 6,) [cam_params.ravel(), points.ravel(), stats]
    packed: Optional[torch.Tensor] = None


def make_cam_params(rvec, tvec, K) -> np.ndarray:
    """Host-side packing of one camera: (10,) float32
    [rvec, tvec, fx, fy, cx, cy]."""
    K = np.asarray(K)
    return np.concatenate([
        np.asarray(rvec, np.float32).reshape(3),
        np.asarray(tvec, np.float32).reshape(3),
        np.asarray([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32)])


def unpack_cam_params(p: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., 10) -> (rvec, tvec, K (..., 3, 3))."""
    fx, fy, cx, cy = p[..., 6], p[..., 7], p[..., 8], p[..., 9]
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    K = torch.stack([torch.stack([fx, zero, cx], -1),
                     torch.stack([zero, fy, cy], -1),
                     torch.stack([zero, zero, one], -1)], -2)
    return p[..., :3], p[..., 3:6], K


def _residual(cam: torch.Tensor, X: torch.Tensor, uv: torch.Tensor
              ) -> torch.Tensor:
    """(..., 2) reprojection residual of cameras (..., 10), points (..., 3)
    and measurements (..., 2)."""
    R = exp_so3(cam[..., :3])
    Xc = (R @ X[..., None])[..., 0] + cam[..., 3:6]
    z = Xc[..., 2]
    zsafe = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    u = Xc[..., 0] / zsafe * cam[..., 6] + cam[..., 8]
    v = Xc[..., 1] / zsafe * cam[..., 7] + cam[..., 9]
    r = torch.stack([u, v], -1) - uv
    # behind the camera: the reference's 100 px sentinel (zero Jacobian).
    # A NaN residual stays NaN, as jnp.sign(nan) is (torch.sign gives 0),
    # so a diverged LM step costs NaN and is rejected as in the reference
    sentinel = torch.where(torch.isnan(r), r, torch.sign(r) * 100.0)
    return torch.where((z > 1e-6)[..., None], r, sentinel)


_jacobians = vmap(jacfwd(_residual, argnums=(0, 1)))


def residuals(prob: BAProblem) -> torch.Tensor:
    """(M, 2) masked reprojection residuals."""
    r = _residual(prob.cam_params[prob.obs_cam], prob.points[prob.obs_pt],
                  prob.obs_uv)
    return r * prob.obs_mask[:, None]


def _huber_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weights of the Huber loss on each observation's residual norm."""
    norm = torch.linalg.vector_norm(r, dim=-1)
    return torch.clamp(delta / torch.clamp(norm, min=1e-12), max=1.0)


def _huber_cost(r: torch.Tensor, mask: torch.Tensor, delta: float
                ) -> torch.Tensor:
    n2 = (r * r).sum(-1)
    n = torch.sqrt(torch.clamp(n2, min=1e-24))
    return (torch.where(n <= delta, 0.5 * n2, delta * (n - 0.5 * delta))
            * mask).sum()


def mean_reproj_error(prob: BAProblem) -> torch.Tensor:
    n = torch.linalg.vector_norm(residuals(prob), dim=-1)
    m = prob.obs_mask.to(n.dtype)
    return (n * m).sum() / torch.clamp(m.sum(), min=1.0)


class _Segments(NamedTuple):
    """Rows -> `n` segments for `_segsum`, built once a solve. With
    `order` set the rows are summed in a fixed order: stably sorted by
    segment, in chunks of at most SEG_CHUNK rows (`chunk_len`), then the
    chunks of each segment (`seg_chunks` of them)."""
    idx: torch.Tensor
    n: int
    order: Optional[torch.Tensor] = None
    chunk_len: Optional[torch.Tensor] = None
    seg_chunks: Optional[torch.Tensor] = None


def _segments(idx: torch.Tensor, n: int,
              fixed_order: Optional[bool] = None) -> _Segments:
    """Segments of `idx` (M,) into n. `fixed_order` defaults to CUDA:
    `index_add_` adds in row order on the CPU, but by float atomics there.
    Two segmented reductions replace them (each thread sums its rows in
    order); the chunks keep a camera's 10^4 rows from one thread."""
    if not (idx.is_cuda if fixed_order is None else fixed_order):
        return _Segments(idx, n)
    order = torch.argsort(idx, stable=True)
    counts = torch.bincount(idx, minlength=n)
    nch = (counts + SEG_CHUNK - 1) // SEG_CHUNK
    seg = torch.repeat_interleave(torch.arange(n, device=idx.device), nch)
    rank = (torch.arange(seg.numel(), device=idx.device)
            - (torch.cumsum(nch, 0) - nch)[seg])
    chunk_len = torch.clamp(counts[seg] - rank * SEG_CHUNK, max=SEG_CHUNK)
    return _Segments(idx, n, order, chunk_len, nch)


def _segsum(x: torch.Tensor, seg: _Segments) -> torch.Tensor:
    """jax.ops.segment_sum: rows of x added into seg.n segments."""
    out = torch.zeros((seg.n,) + x.shape[1:], dtype=x.dtype, device=x.device)
    if seg.order is None:
        return out.index_add_(0, seg.idx, x)
    if seg.chunk_len.numel() == 0:
        return out
    part = torch.segment_reduce(x[seg.order], "sum", lengths=seg.chunk_len,
                                axis=0)
    return torch.segment_reduce(part, "sum", lengths=seg.seg_chunks, axis=0)


def _damp(B: torch.Tensor, lam: torch.Tensor, eps: float) -> torch.Tensor:
    """Marquardt damping, multiplicative on the diagonal."""
    d = torch.clamp(torch.diagonal(B, dim1=-2, dim2=-1), min=eps)
    return B + lam * torch.diag_embed(d)


def bundle_adjust(prob: BAProblem,
                  config: BAConfig = BAConfig(),
                  axis_name: Optional[str] = None,
                  lambda0=None,
                  skip_below_px=None) -> BAResult:
    """Schur-complement LM on the problem's device.

    `lambda0` warm-starts the damping (the previous solve's final lambda,
    clipped to [1e-9, 1e6]); `skip_below_px` replaces the value of
    `config.skip_if_below_px` (the config field still enables the gate).
    The sharded form (`axis_name`) is not ported."""
    if axis_name is not None:
        raise NotImplementedError(
            "bundle_adjust(axis_name=...): the sharded point-block path "
            "(parallel/ba.py) is ROADMAP Queue 1 #10, not ported yet")
    C = prob.cam_params.shape[0]
    P = prob.points.shape[0]
    dev = prob.cam_params.device
    delta = config.huber_delta
    solver = config.schur_solver
    if solver == "auto":
        solver = "dense" if C <= 32 else "cg"
    if solver not in ("dense", "cg"):
        raise ValueError(f"schur_solver must be 'auto', 'dense' or 'cg', "
                         f"got {config.schur_solver!r}")

    # observations sorted by point id (stable), as the reference sorts
    order = torch.argsort(prob.obs_pt, stable=True)
    obs_cam = prob.obs_cam[order].long()
    obs_pt = prob.obs_pt[order].long()
    obs_uv = prob.obs_uv[order]
    obs_mask = prob.obs_mask[order]
    cam_seg, pt_seg = _segments(obs_cam, C), _segments(obs_pt, P)
    if solver == "dense":
        # W's (point, camera) blocks, one segment each
        blk_seg = _segments(obs_pt * C + obs_cam, P * C)

    pmask = prob.param_mask.to(torch.float32)
    if not config.optimize_intrinsics:
        pmask = pmask.clone()
        pmask[:, 6:] = 0.0
    ptmask = prob.point_mask.to(torch.float32)
    live = obs_mask.to(torch.float32) * ptmask[obs_pt]          # (M,)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eyec = torch.eye(CAM_DIM, dtype=torch.float32, device=dev)

    def cost_of(cams, pts):
        r = _residual(cams[obs_cam], pts[obs_pt], obs_uv)
        return _huber_cost(r, live, delta)

    def solve_cg(Ud, Wm, WVm, gc, gp):
        def matvec(x):
            z = _segsum(torch.einsum("mij,mi->mj", Wm, x[obs_cam]), pt_seg)
            back = _segsum(torch.einsum("mil,ml->mi", WVm, z[obs_pt]), cam_seg)
            return (torch.einsum("cij,cj->ci", Ud, x) - back) * pmask

        rhs = (gc - _segsum(torch.einsum("mil,ml->mi", WVm, gp[obs_pt]),
                            cam_seg)) * pmask
        # block-Jacobi preconditioner from the exact diagonal blocks
        Dblk = Ud - _segsum(torch.einsum("mil,mjl->mij", WVm, Wm), cam_seg)
        Dblk = (Dblk * (pmask[:, :, None] * pmask[:, None, :])
                + eyec * (1.0 - pmask[:, :, None] * eyec))
        Minv = torch.linalg.inv_ex(Dblk + 1e-8 * eyec)[0]

        def precond(v):
            return torch.einsum("cij,cj->ci", Minv, v) * pmask

        tol = config.cg_tol * (torch.sqrt((rhs * rhs).sum()) + 1e-30)
        x = torch.zeros_like(rhs)
        rr = rhs
        p_ = precond(rhs)
        rz = (rhs * p_).sum()
        it = torch.zeros((), dtype=torch.int32, device=dev)

        def running():
            return (it < config.cg_iters) & (torch.sqrt((rr * rr).sum()) > tol)

        done_iters = 0
        while done_iters < config.cg_iters:
            for _ in range(min(CG_CHECK, config.cg_iters - done_iters)):
                on = running()
                Ap = matvec(p_)
                alpha = rz / torch.clamp((p_ * Ap).sum(), min=1e-30)
                x_n = x + alpha * p_
                rr_n = rr - alpha * Ap
                z = precond(rr_n)
                rz_n = (rr_n * z).sum()
                p_n = z + rz_n / torch.clamp(rz, min=1e-30) * p_
                x, rr, p_, rz = (torch.where(on, a, b) for a, b in
                                 ((x_n, x), (rr_n, rr), (p_n, p_), (rz_n, rz)))
                it = it + on.to(torch.int32)
            done_iters += CG_CHECK
            if not bool(running()):
                break
        return x

    def solve_dense(Ud, Wm, Vinv, gc, gp):
        Wb = _segsum(Wm, blk_seg).reshape(P, C, CAM_DIM, 3)
        # S = U_blockdiag - sum_p W_p V_p^-1 W_p^T
        WV = torch.einsum("pcij,pjl->pcil", Wb, Vinv)
        S = -torch.einsum("pail,pbml->abim", WV, Wb)
        idx = torch.arange(C, device=dev)
        S[idx, idx] += Ud
        S2 = S.permute(0, 2, 1, 3).reshape(C * CAM_DIM, C * CAM_DIM)
        rhs = (gc - torch.einsum("pcij,pj->ci", WV, gp)).reshape(-1)
        # frozen parameters: identity rows keep S nonsingular
        free = pmask.reshape(-1)
        S2 = S2 * free[:, None] * free[None, :] + torch.diag(
            torch.where(free > 0, 0.0, 1.0))
        dc = torch.linalg.solve_ex(S2, rhs * free)[0]
        return dc.reshape(C, CAM_DIM)

    def build_and_solve(cams, pts, lam):
        cam_o = cams[obs_cam]
        pt_o = pts[obs_pt]
        r = _residual(cam_o, pt_o, obs_uv)                          # (M, 2)
        sw = torch.sqrt(_huber_weights(r, delta) * live)            # (M,)
        Jc, Jp = _jacobians(cam_o, pt_o, obs_uv)                    # (M,2,10), (M,2,3)
        # frozen parameters at the Jacobian level
        Jc = Jc * (pmask[obs_cam] * sw[:, None])[:, None, :]
        Jp = Jp * sw[:, None, None]
        nrw = -(r * sw[:, None])

        U = _segsum(torch.einsum("mri,mrj->mij", Jc, Jc), cam_seg)
        V = _segsum(torch.einsum("mri,mrj->mij", Jp, Jp), pt_seg)
        gc = _segsum(torch.einsum("mri,mr->mi", Jc, nrw), cam_seg)
        gp = _segsum(torch.einsum("mri,mr->mi", Jp, nrw), pt_seg)
        Ud = _damp(U, lam, 1e-6)
        Vinv = torch.linalg.inv_ex(_damp(V, lam, 1e-8) + 1e-9 * eye3)[0]
        Wm = torch.einsum("mri,mrj->mij", Jc, Jp)                  # (M, 10, 3)
        if solver == "dense":
            dc = solve_dense(Ud, Wm, Vinv, gc, gp)
        else:
            WVm = torch.einsum("mij,mjl->mil", Wm, Vinv[obs_pt])
            dc = solve_cg(Ud, Wm, WVm, gc, gp)
        dc = dc * pmask
        # back-substitute the points: dp = Vinv (gp - W^T dc)
        WTdc = _segsum(torch.einsum("mij,mi->mj", Wm, dc[obs_cam]), pt_seg)
        dp = torch.einsum("pij,pj->pi", Vinv, gp - WTdc) * ptmask[:, None]
        return dc, dp

    cams, pts = prob.cam_params, prob.points
    cost = cost0 = cost_of(cams, pts)
    # the initial masked mean reprojection, for the skip gate and stats
    n0 = torch.linalg.vector_norm(_residual(cams[obs_cam], pts[obs_pt],
                                            obs_uv), dim=-1)
    mr0 = (n0 * live).sum() / torch.clamp(live.sum(), min=1.0)
    if config.skip_if_below_px <= 0:
        done = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        thr = (config.skip_if_below_px if skip_below_px is None
               else skip_below_px)
        done = mr0 < torch.as_tensor(thr, dtype=torch.float32, device=dev)

    lam = torch.tensor(config.lambda_init if lambda0 is None else lambda0,
                       dtype=torch.float32, device=dev)
    if lambda0 is not None:
        lam = torch.clamp(lam, 1e-9, 1e6)
    iters = 0
    while iters < config.max_iters and not bool(done):
        dc, dp = build_and_solve(cams, pts, lam)
        new_cams, new_pts = cams + dc, pts + dp
        new_cost = cost_of(new_cams, new_pts)
        accept = new_cost < cost
        cams = torch.where(accept, new_cams, cams)
        pts = torch.where(accept, new_pts, pts)
        lam = torch.clamp(torch.where(accept, lam * config.lambda_down,
                                      lam * config.lambda_up), 1e-9, 1e6)
        rel = (cost - new_cost).abs() / torch.clamp(cost, min=1e-12)
        done = accept & (rel < config.ftol)
        cost = torch.where(accept, new_cost, cost)
        iters += 1

    nf = torch.linalg.vector_norm(
        _residual(cams[obs_cam], pts[obs_pt], obs_uv), dim=-1)
    mf = obs_mask.to(nf.dtype)
    mean_px = (nf * mf).sum() / torch.clamp(mf.sum(), min=1.0)
    iterations = torch.tensor(iters, dtype=torch.int32, device=dev)
    stats = torch.stack([cost0, cost, iterations.to(torch.float32), mean_px,
                         lam, mr0])
    return BAResult(cam_params=cams, points=pts, cost_initial=cost0,
                    cost_final=cost, iterations=iterations,
                    mean_reproj_px=mean_px, stats=stats,
                    packed=torch.cat([cams.reshape(-1), pts.reshape(-1),
                                      stats]))
