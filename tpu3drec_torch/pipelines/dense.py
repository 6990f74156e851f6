"""Dense reconstruction pipeline: multi-view stereo -> depth fusion ->
point cloud -> mesh -> export.

Port of `tpu3drec/pipelines/dense.py` (single-device branch). It takes
the same sparse-stage dict (camera_matrix / rotation / translation per
view, points_3d) and numpy images, and returns the same report dict;
`_arrays` holds numpy arrays in the reference's layout. Inputs and
outputs are framework-neutral, so nothing needs converting between the
two packages.

Stereo, fusion, backprojection, outlier filtering, normals and the TSDF
fusion run on the pipeline's device; the voxel-hash kNN, analytics,
marching tetrahedra and mesh post-processing are host numpy, as in the
reference. The mesh is a TSDF (default), an implicit surface of the
cloud (`mesh_method` "poisson", "ball_pivot" or "alpha", `ops/implicit.py`,
its fields on the pipeline's device) or a depth-grid mesh;
`run_multi_reference` merges one cloud per reference view by ICP and
meshes the union. A degenerate cloud (an empty mesh, or too few points
for numpy: `ValueError` / `IndexError`) degrades to the reference's
depth-grid or Delaunay mesh; a `RuntimeError` (a CUDA or kernel fault)
propagates. Besides the stereo stage's ranges (`ops/stereo.py`), the
later stages run under profiler ranges `dense.outliers`,
`dense.normals`, `dense.cloud_quality`, `dense.mesh_extract` and
`dense.mesh_post`. Not ported yet (ROADMAP.md Queue 1 #10): the sharded
multi-card stereo branch, which raises NotImplementedError.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from tpu3drec_torch.core.device import resolve_device
from tpu3drec_torch.ops import mesh as mesh_ops
from tpu3drec_torch.ops import pointcloud as pc
from tpu3drec_torch.ops.implicit import _median_nn_spacing
from tpu3drec_torch.ops.stereo import (
    fuse_depth_blocks, stereo_depth_pairs_block, stereo_depth_pairs_fused,
)
from tpu3drec_torch.ops.tsdf import tsdf_mesh

_IMPLICIT = ("poisson", "ball_pivot", "alpha")
_FUSED_MAX = 6   # neighbour views fused in one call up to here
_CHUNK = 4       # block size for larger folders
# what numpy raises on a degenerate cloud (no points, too few to mesh):
# the reference's degraded modes catch these, a RuntimeError propagates
_DEGENERATE = (ValueError, IndexError)


def validate_sparse_input(sparse: Dict) -> List[str]:
    """Required-fields check of the sparse-stage dict."""
    problems = []
    cams = sparse.get("camera_poses") or sparse.get("cameras")
    if not cams:
        problems.append("missing camera_poses")
        return problems
    for name, c in cams.items():
        for field in ("camera_matrix", "rotation", "translation"):
            if field not in c and field.rstrip("_matrix") not in c:
                problems.append(f"camera {name}: missing {field}")
    if "points_3d" not in sparse:
        problems.append("missing points_3d")
    return problems


class DenseReconstructionPipeline:
    """Pairwise SGM stereo against a reference view, fusion, point cloud
    with normals and analytics, and a TSDF, implicit-surface or
    depth-grid mesh.

    `device=None` means CUDA and raises without a card; pass
    device="cpu" to run the plain versions of the kernels on the CPU."""

    def __init__(self, num_disparities: int = 64,
                 fusion_method: str = "weighted",
                 voxel_size: Optional[float] = None,
                 mesh_method: str = "tsdf",
                 mesh_stride: int = 2,
                 tsdf_resolution: int = 96,
                 outlier_k: int = 20, outlier_std: float = 2.0,
                 max_cloud_points: int = 200_000,
                 use_sharded_stereo: bool = True,
                 device=None):
        self.device = resolve_device(device)
        self.use_sharded_stereo = use_sharded_stereo
        self.num_disparities = num_disparities
        self.fusion_method = fusion_method
        self.voxel_size = voxel_size
        # "tsdf" = volumetric fusion + marching tetrahedra; "poisson",
        # "ball_pivot", "alpha" = implicit surfaces of the cloud;
        # "depth_grid" = 2.5D reference-view grid mesh (also the fallback)
        self.mesh_method = mesh_method
        self.mesh_stride = mesh_stride
        self.tsdf_resolution = tsdf_resolution
        self.outlier_k = outlier_k
        self.outlier_std = outlier_std
        self.max_cloud_points = max_cloud_points

    # ------------------------------------------------------------------
    def _stereo(self, img_ref, images, others, cam_of, K_ref, R_ref, t_ref):
        """Stage 1: every neighbour against the reference, fused. Returns
        (fused, fused_valid) on the device and the per-view baselines and
        valid fractions, pulled to the host."""
        dev = self.device
        K2l, Rl, tl = [], [], []
        for n in others:
            K2, R2, t2 = cam_of(n)
            # relative pose: x2 = R_rel x_ref + t_rel
            R_rel = R2 @ R_ref.T
            K2l.append(K2.astype(np.float32))
            Rl.append(R_rel.astype(np.float32))
            tl.append((t2 - R_rel @ t_ref).astype(np.float32))
        K2l, Rl, tl = (torch.from_numpy(np.stack(a)) for a in (K2l, Rl, tl))
        K_ref32 = torch.from_numpy(K_ref.astype(np.float32))
        im_dev = torch.from_numpy(np.stack(
            [np.asarray(images[n], np.float32) for n in others])).to(dev)
        if len(others) <= _FUSED_MAX:
            fout = stereo_depth_pairs_fused(
                img_ref, im_dev, K_ref32, K2l, Rl, tl,
                num_disparities=self.num_disparities,
                fusion=self.fusion_method)
            # ONE small host pull for all per-view scalars
            meta = fout["meta"].cpu().numpy()
            return (fout["fused_depth"], fout["fused_valid"],
                    [float(b) for b in meta[0]], meta[1])
        d_blocks, v_blocks, b_blocks = [], [], []
        for s in range(0, len(others), _CHUNK):
            bout = stereo_depth_pairs_block(
                img_ref, im_dev[s:s + _CHUNK], K_ref32, K2l[s:s + _CHUNK],
                Rl[s:s + _CHUNK], tl[s:s + _CHUNK],
                num_disparities=self.num_disparities)
            d_blocks.append(bout["depths"])
            v_blocks.append(bout["valids"])
            b_blocks.append(bout["baselines"])
        bs = torch.cat(b_blocks)
        fout = fuse_depth_blocks(torch.cat(d_blocks), torch.cat(v_blocks), bs,
                                 fusion=self.fusion_method)
        fracs = fout["valid_fractions"].cpu().numpy()
        return (fout["fused_depth"], fout["fused_valid"],
                [float(b) for b in bs], fracs)

    def run_complete_pipeline(self, sparse: Dict,
                              images: Dict[str, np.ndarray],
                              reference_view: Optional[str] = None,
                              output_dir=None) -> Dict:
        problems = validate_sparse_input(sparse)
        if problems:
            raise ValueError("invalid sparse input: " + "; ".join(problems))
        cams = sparse.get("camera_poses") or sparse["cameras"]
        names = [n for n in cams if n in images]
        if len(names) < 2:
            raise ValueError("need >= 2 posed images for dense stereo")
        ref = reference_view or names[len(names) // 2]
        others = [n for n in names if n != ref]
        dev = self.device
        if (self.use_sharded_stereo and dev.type == "cuda"
                and torch.cuda.device_count() > 1 and len(others) > 1):
            raise NotImplementedError(
                "sharded multi-card stereo is not ported yet (ROADMAP.md "
                "Queue 1 #10); pass use_sharded_stereo=False for one card")
        t_start = time.perf_counter()

        def cam_of(n):
            c = cams[n]
            K = np.asarray(c.get("camera_matrix", c.get("K")), np.float64)
            R = np.asarray(c.get("rotation", c.get("R")), np.float64)
            t = np.asarray(c.get("translation", c.get("t")),
                           np.float64).reshape(3)
            return K, R, t

        K_ref, R_ref, t_ref = cam_of(ref)
        img_ref = torch.from_numpy(np.asarray(images[ref], np.float32)).to(dev)

        # ---- stage 1: pairwise stereo vs reference + fusion ----------
        # the fused depth lives in the ORIGINAL reference view (each pair
        # is un-rectified before fusion), so K_ref/R_ref/t_ref
        # backprojection below is frame-correct for rotated rigs
        fused, fused_valid, baselines, fracs = self._stereo(
            img_ref, images, others, cam_of, K_ref, R_ref, t_ref)
        per_view = {n: {"valid_fraction": float(fr)}
                    for n, fr in zip(others, fracs)}
        t_stereo = time.perf_counter()

        # ---- stage 2: point cloud -------------------------------------
        stride = max(1, int(np.ceil(np.sqrt(
            fused.shape[0] * fused.shape[1] / self.max_cloud_points))))
        with record_function("dense.outliers"):
            pts, colors, mask = pc.depth_map_to_point_cloud(
                fused, K_ref.astype(np.float32), R_ref.astype(np.float32),
                t_ref.astype(np.float32), image=img_ref, valid=fused_valid,
                stride=stride)
            mask = pc.statistical_outlier_mask(
                pts, mask, k=self.outlier_k, std_ratio=self.outlier_std)
        # O(N^2) kNN normals up to 16k points, voxel-hash kNN beyond
        with record_function("dense.normals"):
            viewpoint = (-R_ref.T @ t_ref).astype(np.float32)
            if pts.shape[0] <= 16384:
                normals = pc.estimate_normals(pts, mask, viewpoint=viewpoint)
            else:
                normals = pc.estimate_normals_scaled(pts, mask,
                                                     viewpoint=viewpoint)
            pts_np = pts[mask].cpu().numpy()
            colors_np = (colors[mask].cpu().numpy() if colors is not None
                         else None)
            normals_np = normals[mask].cpu().numpy()
        with record_function("dense.cloud_quality"):
            if self.voxel_size:
                pts_np, colors_np = pc.voxel_downsample(
                    pts_np, self.voxel_size, colors_np)
            cloud_quality = pc.point_cloud_quality(pts_np, colors=colors_np)
            cloud_quality["normals_computed"] = int(len(normals_np))
        t_cloud = time.perf_counter()

        # ---- stage 3: mesh ---------------------------------------------
        fused_np = fused.cpu().numpy()
        fused_valid_np = fused_valid.cpu().numpy()
        mesh_method_used = self.mesh_method
        with record_function("dense.mesh_extract"):
            if self.mesh_method == "tsdf" and fused_valid_np.any():
                # no try here: a fault on the device raises
                tm = tsdf_mesh(fused_np, fused_valid_np,
                               K_ref.astype(np.float32),
                               R_ref.astype(np.float32),
                               t_ref.astype(np.float32),
                               resolution=self.tsdf_resolution, device=dev)
                verts, faces = tm["verts"], tm["faces"]
            elif self.mesh_method in _IMPLICIT:
                verts, faces = self._implicit_mesh(pts_np, normals_np)
                if len(faces) == 0:
                    mesh_method_used = "depth_grid"
            else:
                mesh_method_used = "depth_grid"   # or nothing valid to fuse
            if mesh_method_used == "depth_grid":
                verts, faces = mesh_ops.depth_map_to_mesh(
                    fused_np, K_ref, R_ref, t_ref, valid=fused_valid_np,
                    stride=self.mesh_stride)
        with record_function("dense.mesh_post"):
            verts, faces = mesh_ops.repair_mesh(verts, faces)
            verts, faces = mesh_ops.smooth_mesh(verts, faces, iterations=2)
            vert_colors = mesh_ops.project_texture(
                verts, {n: dict(zip(("K", "R", "t"), cam_of(n)))
                        for n in names},
                {n: np.asarray(images[n]) for n in names})
            mq = mesh_ops.mesh_quality(verts, faces)
        t_mesh = time.perf_counter()

        results = {
            "reference_view": ref,
            "num_views": len(names),
            "depth": {
                "shape": list(fused_np.shape),
                "valid_fraction": float(fused_valid_np.mean()),
                "per_view": per_view,
                "baselines": baselines,
            },
            "point_cloud": {"num_points": int(len(pts_np)), **cloud_quality},
            "mesh": {"method": mesh_method_used, **mq},
            "timings_s": {
                "stereo": t_stereo - t_start,
                "point_cloud": t_cloud - t_stereo,
                "mesh": t_mesh - t_cloud,
                "total": t_mesh - t_start,
            },
        }

        if output_dir is not None:
            out = Path(output_dir)
            out.mkdir(parents=True, exist_ok=True)
            np.save(out / "fused_depth.npy", fused_np)
            pc.save_ply(out / "point_cloud.ply", pts_np, colors_np,
                        normals=(normals_np if len(normals_np) == len(pts_np)
                                 else None))
            mesh_ops.save_obj(out / "mesh.obj", verts, faces, vert_colors)
            (out / "dense_report.json").write_text(
                json.dumps(results, indent=2, default=str))
            results["output_dir"] = str(out)

        self._arrays = {"depth": fused_np, "points": pts_np,
                        "colors": colors_np, "normals": normals_np,
                        "vertices": verts, "faces": faces}
        return results

    def _implicit_mesh(self, pts_np: np.ndarray, normals_np: np.ndarray):
        """The implicit-surface mesh of the cloud at `tsdf_resolution`;
        an empty one where numpy finds the cloud degenerate."""
        dev = self.device
        # no normals where the voxel downsample broke lockstep
        nrm = normals_np if len(normals_np) == len(pts_np) else None
        try:
            if self.mesh_method == "poisson":
                return mesh_ops.create_mesh_poisson(
                    pts_np, nrm, resolution=self.tsdf_resolution, device=dev)
            if self.mesh_method == "ball_pivot":
                return mesh_ops.create_mesh_ball_pivoting(
                    pts_np, nrm, resolution=self.tsdf_resolution, device=dev)
            return mesh_ops.create_mesh_alpha_shape(
                pts_np, alpha=max(3.0 * _median_nn_spacing(pts_np), 1e-6),
                resolution=self.tsdf_resolution, device=dev)
        except _DEGENERATE:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    # ------------------------------------------------------------------
    def run_multi_reference(self, sparse: Dict, images: Dict[str, np.ndarray],
                            num_refs: int = 2, output_dir=None) -> Dict:
        """Multi-reference-view dense mode: one cloud per reference view
        (spread across the folder), each from the standard fused stereo
        pipeline and already in world coordinates, chained through
        `ops.pointcloud.merge_point_clouds` with ICP absorbing the small
        residual misalignments, then meshed with an implicit method:
        ball pivoting where `mesh_method` is "ball_pivot" or "alpha" (as
        the reference does), else Poisson; Delaunay where the merged
        cloud is degenerate."""
        cams = sparse.get("camera_poses") or sparse["cameras"]
        names = [n for n in cams if n in images]
        if len(names) < 2:
            raise ValueError("need >= 2 posed images")
        dev = self.device
        num_refs = max(1, min(num_refs, len(names)))
        refs = [names[int(round(i * (len(names) - 1) / max(num_refs - 1, 1)))]
                for i in range(num_refs)]
        refs = list(dict.fromkeys(refs))
        t0 = time.perf_counter()
        clouds, per_ref = [], {}
        for ref in refs:
            res = self.run_complete_pipeline(sparse, images,
                                             reference_view=ref)
            clouds.append((self._arrays["points"], self._arrays["colors"]))
            per_ref[ref] = {
                "num_points": int(len(self._arrays["points"])),
                "valid_fraction": res["depth"]["valid_fraction"],
            }
        merged_p, merged_c = pc.merge_point_clouds(clouds, registration="icp",
                                                   device=dev)
        if self.voxel_size:
            merged_p, merged_c = pc.voxel_downsample(merged_p,
                                                     self.voxel_size, merged_c)
        quality = pc.point_cloud_quality(merged_p, colors=merged_c)
        mesh_method = (self.mesh_method if self.mesh_method in _IMPLICIT
                       else "poisson")
        try:
            pts_t = torch.from_numpy(np.asarray(merged_p, np.float32)).to(dev)
            nrm = pc.estimate_normals_scaled(
                pts_t, torch.ones(len(merged_p), dtype=torch.bool,
                                  device=dev)).cpu().numpy()
            verts, faces = mesh_ops.create_mesh_poisson(
                merged_p, nrm, resolution=self.tsdf_resolution, device=dev) \
                if mesh_method == "poisson" else \
                mesh_ops.create_mesh_ball_pivoting(
                    merged_p, nrm, resolution=self.tsdf_resolution,
                    device=dev)
            if len(faces) == 0:
                raise ValueError("empty mesh")
        except _DEGENERATE:
            mesh_method = "delaunay"
            verts, faces = mesh_ops.delaunay_mesh(merged_p)
        verts, faces = mesh_ops.repair_mesh(verts, faces)
        results = {
            "mode": "multi_reference",
            "reference_views": refs,
            "per_reference": per_ref,
            "point_cloud": {"num_points": int(len(merged_p)), **quality},
            "mesh": {"method": mesh_method,
                     **mesh_ops.mesh_quality(verts, faces)},
            "timings_s": {"total": time.perf_counter() - t0},
        }
        if output_dir is not None:
            out = Path(output_dir)
            out.mkdir(parents=True, exist_ok=True)
            pc.save_ply(out / "point_cloud_merged.ply", merged_p, merged_c)
            mesh_ops.save_obj(out / "mesh_merged.obj", verts, faces)
            (out / "dense_report.json").write_text(
                json.dumps(results, indent=2, default=str))
            results["output_dir"] = str(out)
        self._arrays = {"points": merged_p, "colors": merged_c,
                        "vertices": verts, "faces": faces}
        return results


def run_dense_reconstruction(sparse_reconstruction: Dict,
                             images: Dict[str, np.ndarray],
                             output_dir=None,
                             reference_view: Optional[str] = None,
                             **kw) -> Dict:
    """Convenience entry: `DenseReconstructionPipeline(**kw)` on one
    folder (`device=None` means CUDA)."""
    pipe = DenseReconstructionPipeline(**kw)
    return pipe.run_complete_pipeline(sparse_reconstruction, images,
                                      reference_view=reference_view,
                                      output_dir=output_dir)
