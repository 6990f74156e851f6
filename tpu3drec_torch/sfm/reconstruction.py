"""Reconstruction data model: cameras, 3D points, observations.

Port of `tpu3drec/sfm/reconstruction.py`. Host-side containers: per-camera
R, t, K with P = K[R|t] and centre -R^T t, two-way camera<->point indices,
and a `to_legacy_format` dict for export. Storage is struct-of-arrays:
points, colours and observations live in amortised-growth numpy buffers
with per-camera observation row indices, so reconstructions of 50 views,
tens of thousands of points and 1e5+ observations never walk a Python
tuple list on the hot path; `observations` / `observations_of_camera`
remain as tuple views for export and interchange.

`to_ba_problem` / `to_local_ba_problem` pack the port's `BAProblem` on a
device the caller names, at the real counts (the reference pads every
axis to capacity buckets so that XLA reuses its compiled programs; torch
has no compile step to save). The state pickle keeps the reference's
layout, so each package reads the other's checkpoints.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpu3drec_torch.ops.ba import BAProblem
from tpu3drec_torch.ops.lie import exp_so3_np, log_so3_np


@dataclasses.dataclass
class Camera:
    name: str
    R: np.ndarray                 # (3,3) world->cam
    t: np.ndarray                 # (3,)
    K: np.ndarray                 # (3,3)
    image_size: Tuple[int, int] = (0, 0)  # (width, height)

    @property
    def P(self) -> np.ndarray:
        return self.K @ np.concatenate([self.R, self.t[:, None]], axis=1)

    @property
    def center(self) -> np.ndarray:
        return -(self.R.T @ self.t)


class _Grow:
    """Amortised-doubling numpy buffer: O(1) append, zero-copy view."""

    __slots__ = ("_buf", "_n")

    def __init__(self, tail: Tuple[int, ...], dtype, cap: int = 64):
        self._buf = np.empty((cap,) + tail, dtype)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    @property
    def view(self) -> np.ndarray:
        return self._buf[: self._n]

    def extend(self, arr) -> None:
        arr = np.asarray(arr, self._buf.dtype)
        if arr.ndim == self._buf.ndim - 1:
            arr = arr[None]
        k = len(arr)
        need = self._n + k
        if need > len(self._buf):
            cap = max(need, 2 * len(self._buf))
            nb = np.empty((cap,) + self._buf.shape[1:], self._buf.dtype)
            nb[: self._n] = self._buf[: self._n]
            self._buf = nb
        self._buf[self._n: need] = arr
        self._n = need

    def replace(self, arr) -> None:
        self._n = 0
        if len(arr):
            self.extend(arr)


def _cam_rows(cameras: Dict[str, Camera], names: List[str]) -> np.ndarray:
    """(C, 10) float32 [rvec, tvec, fx, fy, cx, cy] of the named cameras."""
    if not names:
        return np.zeros((0, 10), np.float32)
    Rs = np.stack([cameras[n].R for n in names])
    return np.concatenate([
        log_so3_np(Rs).astype(np.float32),
        np.stack([cameras[n].t for n in names]).astype(np.float32),
        np.stack([[cameras[n].K[0, 0], cameras[n].K[1, 1],
                   cameras[n].K[0, 2], cameras[n].K[1, 2]]
                  for n in names]).astype(np.float32),
    ], axis=1)


class Reconstruction:
    """Growable sparse reconstruction."""

    def __init__(self):
        self.cameras: Dict[str, Camera] = {}
        self._cam_id: Dict[str, int] = {}          # name -> insertion index
        self._pts = _Grow((3,), np.float64)
        self._cols = _Grow((3,), np.uint8)
        self._obs_cam = _Grow((), np.int32)        # camera insertion index
        self._obs_pid = _Grow((), np.int32)
        self._obs_uv = _Grow((2,), np.float64)
        # per-camera observation row indices into the obs arrays
        self._cam_rows: Dict[str, _Grow] = {}

    # -- mutation --------------------------------------------------------

    def add_camera(self, cam: Camera) -> None:
        if cam.name not in self._cam_id:
            self._cam_id[cam.name] = len(self._cam_id)
            self._cam_rows[cam.name] = _Grow((), np.int64)
        self.cameras[cam.name] = cam

    def add_point(self, xyz: np.ndarray,
                  color: Optional[np.ndarray] = None) -> int:
        pid = len(self._pts)
        self._pts.extend(np.asarray(xyz, np.float64))
        self._cols.extend(np.asarray(
            color if color is not None else [128, 128, 128], np.uint8))
        return pid

    def add_points_batch(self, xyz: np.ndarray) -> np.ndarray:
        """Append (N, 3) points at once; returns their ids."""
        xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
        n0 = len(self._pts)
        self._pts.extend(xyz)
        self._cols.extend(np.full((len(xyz), 3), 128, np.uint8))
        return np.arange(n0, n0 + len(xyz))

    def add_observation(self, cam_name: str, point_id: int,
                        uv: np.ndarray) -> None:
        self.add_observations_batch(cam_name, [int(point_id)],
                                    np.asarray(uv, np.float64)[None])

    def add_observations_batch(self, cam_name: str, point_ids,
                               uvs: np.ndarray) -> None:
        """Append many observations of one camera at once."""
        point_ids = np.asarray(point_ids, np.int32).reshape(-1)
        if len(point_ids) == 0:
            return
        uvs = np.asarray(uvs, np.float64).reshape(-1, 2)
        ci = self._cam_id.setdefault(cam_name, len(self._cam_id))
        rows = self._cam_rows.setdefault(cam_name, _Grow((), np.int64))
        n0 = len(self._obs_pid)
        self._obs_cam.extend(np.full(len(point_ids), ci, np.int32))
        self._obs_pid.extend(point_ids)
        self._obs_uv.extend(uvs)
        rows.extend(np.arange(n0, n0 + len(point_ids), dtype=np.int64))

    def remove_points(self, point_ids) -> None:
        """Drop points and their observations; ids are remapped densely."""
        point_ids = np.asarray(list(point_ids), int)
        if len(point_ids) == 0:
            return
        drop = np.zeros(self.num_points, bool)
        drop[point_ids] = True
        keep = ~drop
        remap = np.cumsum(keep) - 1                 # new id of kept points
        self._pts.replace(self._pts.view[keep])
        self._cols.replace(self._cols.view[keep])
        okeep = keep[self._obs_pid.view]
        ocam = self._obs_cam.view[okeep]
        opid = remap[self._obs_pid.view[okeep]].astype(np.int32)
        ouv = self._obs_uv.view[okeep]
        self._obs_cam.replace(ocam)
        self._obs_pid.replace(opid)
        self._obs_uv.replace(ouv)
        for name, ci in self._cam_id.items():
            self._cam_rows[name] = g = _Grow((), np.int64)
            g.extend(np.nonzero(ocam == ci)[0])

    # -- queries ----------------------------------------------------------

    @property
    def num_cameras(self) -> int:
        return len(self.cameras)

    @property
    def num_points(self) -> int:
        return len(self._pts)

    @property
    def num_observations(self) -> int:
        return len(self._obs_pid)

    @property
    def points(self) -> np.ndarray:
        """(N, 3) float64 view of the point buffer (read-only contract:
        mutate through update_from_ba / remove_points)."""
        return self._pts.view

    @property
    def point_colors(self) -> np.ndarray:
        return self._cols.view

    @point_colors.setter
    def point_colors(self, value) -> None:
        value = np.asarray(value, np.uint8).reshape(-1, 3)
        if len(value) != self.num_points:
            raise ValueError("color count must match point count")
        self._cols.replace(value)

    @property
    def observations(self) -> List[Tuple[str, int, np.ndarray]]:
        """Tuple-list view (export and pickle interchange); O(N) to build,
        hot paths use obs_arrays()."""
        names = self.camera_names()
        ocam, opid, ouv = self.obs_arrays()
        return [(names[c], int(p), ouv[i])
                for i, (c, p) in enumerate(zip(ocam, opid))]

    def camera_names(self) -> List[str]:
        """Camera names in insertion (= processing) order."""
        return list(self._cam_id)

    def obs_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(cam_idx (N,) int32 in insertion order, pid (N,) int32,
        uv (N, 2) float64) zero-copy views of the observation store."""
        return self._obs_cam.view, self._obs_pid.view, self._obs_uv.view

    def points_array(self) -> np.ndarray:
        if not len(self._pts):
            return np.zeros((0, 3))
        return self._pts.view.copy()

    def points_seen_by(self, cam_name: str) -> set:
        rows = self._cam_rows.get(cam_name)
        if rows is None or not len(rows):
            return set()
        return set(np.unique(self._obs_pid.view[rows.view]).tolist())

    def cameras_seeing(self, point_id: int) -> set:
        names = self.camera_names()
        cis = np.unique(self._obs_cam.view[self._obs_pid.view == point_id])
        return {names[int(ci)] for ci in cis}

    def observations_of_camera(self, cam_name: str
                               ) -> List[Tuple[int, np.ndarray]]:
        pids, uvs = self.camera_obs_arrays(cam_name)
        return [(int(p), uvs[i]) for i, p in enumerate(pids)]

    def camera_obs_arrays(self, cam_name: str
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """(pids (n,), uvs (n, 2)) of one camera."""
        rows = self._cam_rows.get(cam_name)
        if rows is None or not len(rows):
            return np.zeros(0, np.int32), np.zeros((0, 2))
        r = rows.view
        return self._obs_pid.view[r], self._obs_uv.view[r]

    def track_lengths(self) -> np.ndarray:
        """(P,) observation count per point (= distinct cameras: the
        pipeline never adds duplicate (camera, point) observations)."""
        return np.bincount(self._obs_pid.view, minlength=self.num_points)

    def stats(self) -> Dict:
        tl = self.track_lengths()
        return {
            "num_cameras": self.num_cameras,
            "num_points": self.num_points,
            "num_observations": self.num_observations,
            "mean_track_length": float(tl.mean()) if len(tl) else 0.0,
            "camera_names": sorted(self.cameras),
        }

    # -- device conversion --------------------------------------------------

    def to_ba_problem(self, optimize_cams: Optional[List[str]] = None,
                      fix_first: bool = True,
                      optimize_intrinsics: bool = True,
                      device=None) -> Tuple[BAProblem, List[str]]:
        """Pack the whole map into a BAProblem on `device` (None means
        CUDA). optimize_cams: names whose pose is free (None = all); the
        others are frozen through the param mask. Cameras are in sorted
        name order; returns (problem, names)."""
        names = sorted(self.cameras)
        cam_idx = {n: i for i, n in enumerate(names)}
        cams = _cam_rows(self.cameras, names)
        pts = self._pts.view.astype(np.float32)
        # observation camera ids ride in insertion order; remap to the
        # sorted order with one LUT gather
        lut = np.asarray([cam_idx[n] for n in self.camera_names()],
                         np.int32)
        ocam, opid, ouv = self.obs_arrays()
        obs_cam = lut[ocam] if len(ocam) else np.zeros(0, np.int32)

        pm = np.ones((len(names), 10), np.float32)
        if optimize_cams is not None:
            free = {cam_idx[n] for n in optimize_cams if n in cam_idx}
            for i in range(len(names)):
                if i not in free:
                    pm[i] = 0.0
        if fix_first and names:
            pm[0] = 0.0
        if not optimize_intrinsics:
            pm[:, 6:] = 0.0
        prob = BAProblem.from_numpy(cams, pts, obs_cam, opid, ouv,
                                    param_mask=pm, device=device)
        return prob, names

    def to_local_ba_problem(self, optimize_cams: List[str],
                            fix_first: bool = True,
                            optimize_intrinsics: bool = True,
                            device=None
                            ) -> Tuple[BAProblem, List[str], np.ndarray]:
        """Windowed ('local') BA problem on `device` (None means CUDA):
        the points seen by a window camera, all observations of those
        points (frozen anchor cameras included, so the local points stay
        pinned to the map) and the cameras in those observations; about
        constant per view for sequential covisibility, where packing the
        whole map would grow with it.

        Returns (problem, camera names of the subset, local point ids);
        apply results with update_from_local_ba."""
        names = sorted(self.cameras)
        cam_idx = {n: i for i, n in enumerate(names)}
        lut = np.asarray([cam_idx[n] for n in self.camera_names()],
                         np.int32)
        ocam, opid, ouv = self.obs_arrays()
        obs_cam_all = lut[ocam] if len(ocam) else np.zeros(0, np.int32)
        opid = np.asarray(opid, np.int32)

        free_ids = np.asarray(sorted(cam_idx[n] for n in optimize_cams
                                     if n in cam_idx), np.int32)
        win_mask = np.isin(obs_cam_all, free_ids)
        local_pts = np.unique(opid[win_mask])
        obs_keep = np.isin(opid, local_pts)
        sub_cam_ids = np.unique(obs_cam_all[obs_keep])
        sub_names = [names[int(i)] for i in sub_cam_ids]

        cam_remap = np.full(len(names), -1, np.int32)
        cam_remap[sub_cam_ids] = np.arange(len(sub_cam_ids), dtype=np.int32)
        pt_remap = np.full(self.num_points, -1, np.int32)
        pt_remap[local_pts] = np.arange(len(local_pts), dtype=np.int32)

        cams = _cam_rows(self.cameras, sub_names)
        pts = self._pts.view[local_pts].astype(np.float32)
        obs_cam = cam_remap[obs_cam_all[obs_keep]]
        obs_pt = pt_remap[opid[obs_keep]]
        obs_uv = np.asarray(ouv, np.float32)[obs_keep]

        free_local = set(cam_remap[free_ids].tolist())
        pm = np.zeros((len(sub_names), 10), np.float32)
        for i in range(len(sub_names)):
            if i in free_local:
                pm[i] = 1.0
        # gauge: anchor cameras (outside the window) are frozen; when the
        # window covers everything (early views), fix the first camera
        if fix_first and len(free_local) == len(sub_names) and len(pm):
            pm[0] = 0.0
        if not optimize_intrinsics:
            pm[:, 6:] = 0.0
        prob = BAProblem.from_numpy(cams, pts, obs_cam, obs_pt, obs_uv,
                                    param_mask=pm, device=device)
        return prob, sub_names, local_pts

    def _set_cameras(self, cam_params: np.ndarray, names: List[str]) -> None:
        cam_params = np.asarray(cam_params, np.float64)
        Rs = exp_so3_np(cam_params[:len(names), :3])
        for i, n in enumerate(names):
            p = cam_params[i]
            self.cameras[n].R = Rs[i]
            self.cameras[n].t = p[3:6].copy()
            self.cameras[n].K = np.array([[p[6], 0.0, p[8]],
                                          [0.0, p[7], p[9]],
                                          [0.0, 0.0, 1.0]])

    def update_from_local_ba(self, cam_params: np.ndarray,
                             points: np.ndarray, names: List[str],
                             point_ids: np.ndarray) -> None:
        """Write back a local BA's camera subset and point subset (host
        arrays)."""
        self._set_cameras(cam_params, names)
        pts = np.asarray(points, np.float64)
        self._pts.view[point_ids] = pts[:len(point_ids)]

    def update_from_ba(self, cam_params: np.ndarray, points: np.ndarray,
                       names: List[str]) -> None:
        """Write back a whole-map BA (host arrays)."""
        self._set_cameras(cam_params, names)
        pts = np.asarray(points, np.float64)
        n = min(self.num_points, len(pts))
        self._pts.view[:n] = pts[:n]

    # -- export ---------------------------------------------------------

    def to_legacy_format(self) -> Dict:
        """The export dict: camera poses, points, colours, statistics."""
        return {
            "camera_poses": {
                n: {"R": c.R.tolist(), "t": c.t.tolist(), "K": c.K.tolist(),
                    "camera_matrix": c.K.tolist(),
                    "rotation": c.R.tolist(), "translation": c.t.tolist(),
                    "center": c.center.tolist(),
                    "image_size": list(c.image_size)}
                for n, c in self.cameras.items()
            },
            "points_3d": self.points_array().tolist(),
            "point_colors": self._cols.view.tolist(),
            "num_observations": self.num_observations,
            "statistics": self.stats(),
        }

    def save(self, path) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.to_legacy_format(), f)

    # -- full-state checkpointing ----------------------------------------

    def save_state(self, path) -> None:
        """Complete resumable state (cameras, points, observations). The
        pickle keeps the tuple-list observation layout of the reference,
        so checkpoints interchange between the two packages."""
        state = {
            "cameras": {n: {"R": c.R, "t": c.t, "K": c.K,
                            "image_size": c.image_size}
                        for n, c in self.cameras.items()},
            "points": list(self._pts.view),
            "point_colors": list(self._cols.view),
            "observations": self.observations,
        }
        with open(path, "wb") as f:
            pickle.dump(state, f)

    @classmethod
    def load_state(cls, path) -> "Reconstruction":
        """Read a state pickle that either package wrote (plain dicts,
        lists and numpy arrays)."""
        with open(path, "rb") as f:
            state = pickle.load(f)
        recon = cls()
        for n, c in state["cameras"].items():
            recon.add_camera(Camera(n, np.asarray(c["R"]), np.asarray(c["t"]),
                                    np.asarray(c["K"]),
                                    tuple(c["image_size"])))
        if len(state["points"]):
            recon.add_points_batch(np.asarray(state["points"]))
            recon.point_colors = np.asarray(state["point_colors"], np.uint8)
        obs = state["observations"]
        if obs:
            # group by camera to keep the rebuild vectorised
            by_cam: Dict[str, list] = {}
            for cam_name, pid, uv in obs:
                by_cam.setdefault(cam_name, []).append((pid, uv))
            for cam_name, rows in by_cam.items():
                recon.add_observations_batch(
                    cam_name, [p for p, _ in rows],
                    np.stack([uv for _, uv in rows]))
        return recon

    def export_colmap(self, output_dir) -> None:
        from tpu3drec_torch.io.colmap import export_sparse_model
        names = sorted(self.cameras)
        ids = {n: i + 1 for i, n in enumerate(names)}
        cams = {ids[n]: {"K": self.cameras[n].K, "R": self.cameras[n].R,
                         "t": self.cameras[n].t, "name": n,
                         "width": self.cameras[n].image_size[0] or 0,
                         "height": self.cameras[n].image_size[1] or 0}
                for n in names}
        ins_names = self.camera_names()
        ocam, opid, ouv = self.obs_arrays()
        obs = [(ids[ins_names[c]], int(p), uv[0], uv[1])
               for c, p, uv in zip(ocam, opid, ouv)]
        export_sparse_model(output_dir, cams, self.points_array(),
                            self._cols.view if len(self._cols) else None,
                            obs)
