"""Reference-surface compatibility layer.

Port of `tpu3drec/compat.py`: every name of the original framework's
public package (FeatureMatchingExtraction/__init__.py:39-302 and the
SfM / dense class names) under the name its users reach for, mapped onto
the port. Class-per-detector wrappers exist only here and are thin
delegates, not a parallel implementation. Classes that compute take
`device=None` (CUDA) like the port's entry points; tensors are handed
back as numpy where the reference hands back arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

# -- data structures (core_data_structures.py) -------------------------
from tpu3drec_torch.core.types import (
    Features, Matches, ScoreType, MethodResult, MatchingResult,
    DescriptorKind,
)

FeatureData = Features          # reference FeatureData :39
MatchData = Matches             # reference MatchData :104

# -- pipeline & config ---------------------------------------------------
from tpu3drec_torch.pipelines.matching import (
    FeatureProcessingPipeline, create_pipeline,
)
from tpu3drec_torch.core.config import (
    DEFAULT_CONFIG, PRESET_CONFIGS, create_config_from_preset,
    merge_configs, validate_config, save_config, load_config,
)


def get_default_config() -> Dict[str, Any]:
    """Reference config.py:get_default_config equivalent (deep copy)."""
    import copy
    return copy.deepcopy(DEFAULT_CONFIG)


# -- image manager / batch processor (image_manager.py, batch_processor.py)
from tpu3drec_torch.io.images import (
    ImageCache, BatchImageLoader, FolderImageSource, ImageMetadata,
    scan_folder_metadata, scan_folder_quick, create_pairs_from_metadata,
)
from tpu3drec_torch.io.checkpoint import (
    BatchProcessor, load_progress, delete_progress, get_remaining_pairs,
)

# -- matchers / selection (feature_matchers.py, matcher_factory.py) -----
from tpu3drec_torch.ops.match import (
    match_features, match_descriptors, auto_select_matcher,
)
from tpu3drec_torch.core.registry import (
    MatcherFactory, MatcherCompatibilityManager,
)

# -- result converters (result_converters.py) ---------------------------
from tpu3drec_torch.io.converters import (
    MethodReconstructionData, MultiMethodReconstruction,
    VisualizationData, ResultConverter,
    save_for_reconstruction, load_for_reconstruction, export_results_csv,
)

MultiMethodReconstructionData = MultiMethodReconstruction

# -- visualization (visualization.py) ------------------------------------
from tpu3drec_torch.viz import (
    visualize_matches, visualize_keypoints_only, visualize_matches_quick,
    show_matches, visualize_matches_with_scores, plot_method_comparison,
    plot_visualization_data, save_visualization,
)

# -- multi-method detector -----------------------------------------------
from tpu3drec_torch.multi_method import (
    MultiMethodFeatureDetector, create_multi_detector,
)


# -- match filtering utils (utils.py:118-247) ----------------------------

def enhanced_filter_matches_with_homography(features1: Features,
                                            features2: Features,
                                            matches: Matches,
                                            threshold: float = 4.0):
    """utils.py:118 equivalent: RANSAC-homography filter. Returns
    (filtered Matches, H (3,3) np.ndarray or None, inlier_ratio)."""
    from tpu3drec_torch.ops.geometry import find_homography
    p1, p2 = matches.gather_points(features1, features2)
    rr = find_homography(p1, p2, mask=matches.mask, threshold=threshold)
    if not bool(rr.success):
        return matches, None, 0.0
    return (matches.replace(mask=rr.inliers), rr.model.cpu().numpy(),
            float(rr.inlier_ratio))


def adaptive_match_filtering(features1: Features, features2: Features,
                             matches: Matches,
                             threshold: float = 4.0):
    """utils.py:155 equivalent (homography is the one adaptive mode the
    reference ships)."""
    return enhanced_filter_matches_with_homography(
        features1, features2, matches, threshold)


def calculate_reprojection_error(H, features1: Features,
                                 features2: Features,
                                 matches: Matches) -> float:
    """utils.py:195 equivalent: mean symmetric-forward reprojection
    error of the accepted matches under H."""
    import torch
    from tpu3drec_torch.ops.geometry import reprojection_error_homography
    p1, p2 = matches.gather_points(features1, features2)
    return float(reprojection_error_homography(
        torch.as_tensor(np.asarray(H, np.float32), device=p1.device),
        p1, p2, matches.mask))


# -- keypoint (de)serialization (core_data_structures.py:176-205) --------

def keypoint_to_dict(xy, size=1.0, angle=0.0, response=0.0) -> Dict:
    return {"pt": (float(xy[0]), float(xy[1])), "size": float(size),
            "angle": float(angle), "response": float(response)}


def dict_to_keypoint(d: Dict):
    return (np.asarray(d["pt"], np.float32), float(d.get("size", 1.0)),
            float(d.get("angle", 0.0)), float(d.get("response", 0.0)))


def keypoints_to_list(features: Features):
    """Features -> list of keypoint dicts (valid rows only).

    The dict format is the reference's cv2.KeyPoint serialization
    (core_data_structures.py:176-189): `angle` is DEGREES in [0, 360)
    and `size` a diameter, so tpu3drec's radians are converted here —
    reference-side consumers (and cv2.KeyPoint round-trips) read these
    pickles directly."""
    f = features.to_numpy() if hasattr(features, "to_numpy") else features
    out = []
    xy, size = np.asarray(f["xy"]), np.asarray(f["scale"])
    ang, resp = np.asarray(f["angle"]), np.asarray(f["response"])
    ang_deg = np.degrees(ang) % 360.0
    for i in range(len(xy)):
        out.append(keypoint_to_dict(xy[i], size[i], ang_deg[i], resp[i]))
    return out


def list_to_keypoints(items, desc=None, image_shape=(),
                      device=None) -> Features:
    """Inverse of keypoints_to_list: cv2-convention degrees -> radians
    wrapped to (-pi, pi] (this framework's Features.angle unit), on
    `device` (None means CUDA)."""
    xy = np.asarray([d["pt"] for d in items], np.float32).reshape(-1, 2)
    deg = np.asarray([d.get("angle", 0.0) for d in items], np.float32)
    rad = np.radians(deg)
    rad = (rad + np.pi) % (2 * np.pi) - np.pi
    return Features.from_numpy(
        xy, desc if desc is not None else np.zeros((len(xy), 0)),
        response=[d.get("response", 0.0) for d in items],
        scale=[d.get("size", 1.0) for d in items],
        angle=rad,
        image_shape=image_shape, device=device)


# -- class-per-detector shims (traditional_detectors.py,
#    deep_learning_detectors.py) ------------------------------------------

class _DetectorShim:
    """BaseFeatureDetector-shaped wrapper over the functional registry."""

    method: str = "SIFT"

    def __init__(self, max_features: int = 2048, device=None, **params):
        self.max_features = max_features
        self.device = device
        self.params = params

    def detect(self, image) -> Features:
        from tpu3drec_torch.api import detect_features
        return detect_features(image, self.method,
                               max_features=self.max_features,
                               device=self.device, **self.params)

    __call__ = detect


def _make_shim(method: str):
    return type(f"{method}Detector", (_DetectorShim,),
                {"method": method, "__doc__":
                 f"{method} detector shim (functional core: see ops/)."})


SIFTDetector = _make_shim("SIFT")
ORBDetector = _make_shim("ORB")
AKAZEDetector = _make_shim("AKAZE")
BRISKDetector = _make_shim("BRISK")
HarrisCornerDetector = _make_shim("Harris")
GoodFeaturesToTrackDetector = _make_shim("GFTT")
SuperPointDetector = _make_shim("SuperPoint")
DISKDetector = _make_shim("DISK")
ALIKEDDetector = _make_shim("ALIKED")


def create_traditional_detector(method: str = "SIFT", **kw):
    """traditional_detectors.py:288 equivalent."""
    return _make_shim(method)(**kw)


# -- CameraPoseEstimation surface (CPE/pipeline.py, pipeline2.py) --------
from tpu3drec_torch.sfm.reconstruction import (          # noqa: E402
    Reconstruction, Camera,
)
from tpu3drec_torch.sfm.pipeline import SfMConfig, SfMPipeline  # noqa: E402
from tpu3drec_torch.sfm import reconstruct_scene         # noqa: E402
from tpu3drec_torch.sfm.pair_selector import (           # noqa: E402
    InitializationPairSelector, ScoringConfig,
)
from tpu3drec_torch.sfm.quality import assess_reconstruction_quality  # noqa: E402


class MainPosePipeline:
    """Reference MainPosePipeline shim (CPE/pipeline.py:218 /
    pipeline2.py:218): `process_monument_reconstruction(matches_pickle,
    output_dir, chosen_images)` delegates to the port's SfM pipeline.
    Instantiating with `use_iterative_refinement=True` gives pipeline2
    behaviour."""

    def __init__(self, config: Optional[SfMConfig] = None,
                 use_iterative_refinement: bool = False, device=None,
                 **kw):
        cfg = config or SfMConfig(**kw)
        if use_iterative_refinement:
            cfg.use_iterative_refinement = True
        self.config = cfg
        self.device = device
        self.reconstruction: Optional[Reconstruction] = None

    def process_monument_reconstruction(self, matches, output_dir=None,
                                        chosen_images=None):
        self.reconstruction = reconstruct_scene(
            matches, output_dir=output_dir, config=self.config,
            chosen_images=chosen_images, device=self.device)
        return self.reconstruction


# -- DenseReconstruction surface (DR/*.py) -------------------------------
from tpu3drec_torch.pipelines.dense import (             # noqa: E402
    DenseReconstructionPipeline, run_dense_reconstruction,
)


def _dev_tensor(a, device, dtype=None):
    import torch
    t = torch.as_tensor(np.asarray(a))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


class StereoMatcher:
    """Reference StereoMatcher shim (stereo_matching.py:17): pairwise
    depth + multi-view fusion on the port's rectified SGM stereo."""

    def __init__(self, num_disparities: int = 64, device=None, **kw):
        from tpu3drec_torch.core.device import resolve_device
        self.num_disparities = num_disparities
        self.device = resolve_device(device)

    def compute_stereo_depth(self, img1, img2, K1, K2, R, t):
        import torch
        from tpu3drec_torch.ops.stereo import stereo_depth_pair
        f32 = torch.float32
        out = stereo_depth_pair(
            _dev_tensor(np.asarray(img1, np.float32), self.device),
            _dev_tensor(np.asarray(img2, np.float32), self.device),
            *(torch.as_tensor(np.asarray(a, np.float32), dtype=f32)
              for a in (K1, K2, R, t)),
            num_disparities=self.num_disparities)
        return {k: (v.cpu().numpy() if hasattr(v, "cpu") else v)
                for k, v in out.items()}

    def fuse_depth_maps(self, depths, valids, baselines,
                        method: str = "weighted"):
        from tpu3drec_torch.ops.stereo import fuse_depth_maps
        fused, valid = fuse_depth_maps(
            _dev_tensor(np.asarray(depths, np.float32), self.device),
            _dev_tensor(np.asarray(valids, bool), self.device),
            np.asarray(baselines, np.float32), method=method)
        return fused.cpu().numpy(), valid.cpu().numpy()


class PointCloudProcessor:
    """Reference PointCloudProcessor shim
    (point_cloud_processing.py:22)."""

    def __init__(self, device=None):
        from tpu3drec_torch.core.device import resolve_device
        self.device = resolve_device(device)

    def depth_map_to_point_cloud(self, depth, K, R=None, t=None,
                                 image=None, stride: int = 1):
        import torch
        from tpu3drec_torch.ops import pointcloud as pc
        R = np.eye(3) if R is None else np.asarray(R)
        t = np.zeros(3) if t is None else np.asarray(t)
        pts, colors, mask = pc.depth_map_to_point_cloud(
            _dev_tensor(np.asarray(depth, np.float32), self.device),
            torch.as_tensor(np.asarray(K, np.float32)),
            torch.as_tensor(R.astype(np.float32)),
            torch.as_tensor(t.astype(np.float32)),
            image=(_dev_tensor(np.asarray(image, np.float32), self.device)
                   if image is not None else None),
            stride=stride)
        m = mask.cpu().numpy()
        return (pts.cpu().numpy()[m],
                colors.cpu().numpy()[m] if colors is not None else None)

    def filter_point_cloud(self, points, k: int = 16,
                           std_ratio: float = 2.0):
        import torch
        from tpu3drec_torch.ops import pointcloud as pc
        pts = _dev_tensor(np.asarray(points, np.float32), self.device)
        mask = pc.statistical_outlier_mask(
            pts, torch.ones(len(points), dtype=torch.bool,
                            device=self.device), k=k, std_ratio=std_ratio)
        return np.asarray(points)[mask.cpu().numpy()]

    def estimate_normals(self, points, k: int = 16, viewpoint=None):
        import torch
        from tpu3drec_torch.ops import pointcloud as pc
        return pc.estimate_normals(
            _dev_tensor(np.asarray(points, np.float32), self.device),
            torch.ones(len(points), dtype=torch.bool, device=self.device),
            k=k,
            viewpoint=(_dev_tensor(np.asarray(viewpoint, np.float32),
                                   self.device)
                       if viewpoint is not None else None)).cpu().numpy()


class MeshGenerator:
    """Reference MeshGenerator shim (mesh_generation.py:22). Meshes are
    (vertices, faces) ndarray tuples instead of trimesh objects; the
    implicit meshers run on `device` (None means CUDA)."""

    def __init__(self, device=None):
        self.device = device

    def create_mesh_poisson(self, points, normals=None, **kw):
        from tpu3drec_torch.ops.mesh import create_mesh_poisson
        return create_mesh_poisson(points, normals, device=self.device,
                                   **kw)

    def create_mesh_ball_pivoting(self, points, normals=None, **kw):
        from tpu3drec_torch.ops.mesh import create_mesh_ball_pivoting
        return create_mesh_ball_pivoting(points, normals,
                                         device=self.device, **kw)

    def create_mesh_alpha_shape(self, points, alpha: float = 0.03, **kw):
        from tpu3drec_torch.ops.mesh import create_mesh_alpha_shape
        return create_mesh_alpha_shape(points, alpha, device=self.device,
                                       **kw)

    def create_mesh_delaunay(self, points, **kw):
        from tpu3drec_torch.ops.mesh import delaunay_mesh
        return delaunay_mesh(points, **kw)

    def create_mesh_from_depth_map(self, depth_map, K, **kw):
        from tpu3drec_torch.ops.mesh import depth_map_to_mesh
        return depth_map_to_mesh(np.asarray(depth_map), np.asarray(K),
                                 **kw)

    def simplify_mesh(self, mesh, target_faces: int = 1000):
        from tpu3drec_torch.ops.mesh import simplify_mesh
        return simplify_mesh(*mesh, target_faces)

    def smooth_mesh(self, mesh, iterations: int = 5):
        from tpu3drec_torch.ops.mesh import smooth_mesh
        return smooth_mesh(*mesh, iterations=iterations)

    def repair_mesh(self, mesh):
        from tpu3drec_torch.ops.mesh import repair_mesh
        return repair_mesh(*mesh)

    def texture_mesh(self, mesh, cameras, images):
        from tpu3drec_torch.ops.mesh import project_texture
        return mesh[0], mesh[1], project_texture(mesh[0], cameras, images)

    def analyze_mesh_quality(self, mesh):
        from tpu3drec_torch.ops.mesh import mesh_quality
        return mesh_quality(*mesh)

    def compare_meshes(self, mesh1, mesh2):
        from tpu3drec_torch.ops.mesh import compare_meshes
        return compare_meshes(mesh1[0], mesh1[1], mesh2[0], mesh2[1])

    def visualize_mesh(self, mesh, title: str = "Mesh Visualization",
                       **kw):
        from tpu3drec_torch.viz import visualize_mesh
        return visualize_mesh(mesh[0], mesh[1], title=title, **kw)

    def export_mesh(self, mesh, filename: str = "mesh.obj") -> bool:
        from tpu3drec_torch.ops.mesh import save_obj
        save_obj(filename, *mesh)
        return True


# -- remaining reference __all__ names (FME/__init__.py:207-302) ---------
import dataclasses as _dc
import enum as _enum
import pickle as _pickle

from tpu3drec_torch import __version__
from tpu3drec_torch.io.converters import (  # noqa: E402
    export_results_csv as export_summary_csv,
)
from tpu3drec_torch.ops.image import resize as _resize_op

ReconstructionData = MethodReconstructionData   # result_converters alias


@_dc.dataclass
class ImagePairInfo:
    """result_types.py pair-metadata record."""
    image1_name: str = ""
    image2_name: str = ""
    image1_shape: tuple = ()
    image2_shape: tuple = ()

    @property
    def image1(self):
        return self.image1_name

    @property
    def image2(self):
        return self.image2_name


@_dc.dataclass
class ProcessingMetadata:
    """result_types.py:44-51: per-pair timing metadata."""
    total_processing_time: float = 0.0
    method_timings: Dict[str, float] = _dc.field(default_factory=dict)
    timestamp: float = 0.0
    config: Dict[str, Any] = _dc.field(default_factory=dict)


@_dc.dataclass
class VisualMatch:
    """result_converters.py per-match visualization record."""
    pt1: tuple = (0.0, 0.0)
    pt2: tuple = (0.0, 0.0)
    score: float = 0.0
    method: str = ""
    color: tuple = (0, 255, 0)


@_dc.dataclass
class EnhancedDMatch:
    """core_data_structures.py:64-101: match record with the distance <->
    confidence score algebra."""
    queryIdx: int = 0
    trainIdx: int = 0
    distance: float = 0.0
    score_type: str = "distance"

    def as_distance(self) -> float:
        if self.score_type == "distance":
            return self.distance
        return 1.0 - self.distance        # confidence -> pseudo-distance

    def as_confidence(self) -> float:
        if self.score_type == "confidence":
            return self.distance
        return 1.0 / (1.0 + max(self.distance, 0.0))


class MultiMethodFeatureData(dict):
    """{method: Features} container (core_data_structures.py:209+)."""

    @property
    def methods(self):
        return list(self.keys())


class MultiMethodMatchData(dict):
    """{method: Matches} container with offset merging delegated to
    core/multi_match.merge_method_matches."""

    @property
    def methods(self):
        return list(self.keys())


ImageInfo = ImageMetadata                  # image_manager.py alias


class ImageSourceType(_enum.Enum):
    FOLDER = "folder"
    SINGLE = "single"
    SYNTHETIC = "synthetic"


def analyze_batch_reuse(prev, nxt) -> Dict[str, Any]:
    """Module-level alias of BatchImageLoader.analyze_batch_reuse
    (image_manager.py:502-564)."""
    return BatchImageLoader().analyze_batch_reuse(prev, nxt)


def estimate_batch_memory(metas, bytes_per_pixel: int = 4) -> int:
    """Pixel-memory estimate for a batch of ImageMetadata
    (image_manager.py:502-564 analytics)."""
    total = 0
    for m in metas:
        w = getattr(m, "width", 0) or 640
        h = getattr(m, "height", 0) or 480
        total += int(w) * int(h) * bytes_per_pixel
    return total


def save_results_batch(results, path) -> None:
    """Batch pickle of MatchingResults (result_types.py:497-527)."""
    with open(path, "wb") as f:
        _pickle.dump([r.to_dict() if hasattr(r, "to_dict") else r
                      for r in results], f)


def load_results_batch(path):
    """Inverse of save_results_batch."""
    with open(path, "rb") as f:
        return _pickle.load(f)


class _MatcherShim:
    """Thin matcher class (feature_matchers.py:25-252): holds params,
    delegates to the functional exact kNN (`knn2`). 'FLANN' is exact by
    design."""

    def __init__(self, ratio_threshold: float = 0.75, **kw):
        self.ratio_threshold = ratio_threshold
        self.params = kw

    def match(self, features1, features2):
        from tpu3drec_torch.ops.match import match_features
        return match_features(features1, features2,
                              ratio=self.ratio_threshold)


class EnhancedBFMatcher(_MatcherShim):
    pass


class EnhancedFLANNMatcher(_MatcherShim):
    pass


def validate_size(image, min_size: int = 32,
                  max_size: int = 8192) -> bool:
    """utils.py:28-75: dimension sanity check."""
    a = np.asarray(image)
    if a.ndim < 2:
        return False
    h, w = a.shape[:2]
    return min_size <= h <= max_size and min_size <= w <= max_size


def image_size_from_shape(shape) -> tuple:
    """(H, W[, C]) -> (width, height)."""
    return (int(shape[1]), int(shape[0]))


def resize_image(image, max_dimension: int = 1024):
    """utils.py:76-116: aspect-preserving cap on the longest side."""
    a = np.asarray(image, np.float32)
    h, w = a.shape[:2]
    m = max(h, w)
    if m <= max_dimension:
        return a
    scale = max_dimension / m
    import torch
    return _resize_op(torch.from_numpy(np.ascontiguousarray(a)),
                      (int(round(h * scale)),
                       int(round(w * scale)))).numpy()


def print_size_info(image, name: str = "image") -> None:
    a = np.asarray(image)
    print(f"{name}: {a.shape[1]}x{a.shape[0]} "
          f"({a.nbytes / 1e6:.1f} MB, dtype {a.dtype})")


def get_version() -> str:
    return __version__


def get_available_methods() -> Dict[str, Dict[str, bool]]:
    """FME/__init__.py:313-333 equivalent, from the live registry."""
    from tpu3drec_torch.api import _get_detector_registry
    reg = _get_detector_registry()
    return {
        "traditional": {m: m in reg
                        for m in ("SIFT", "ORB", "AKAZE", "BRISK",
                                  "Harris", "GFTT")},
        "deep_learning": {m: m in reg
                          for m in ("SuperPoint", "DISK", "ALIKED")},
    }


def _stage_glue():
    """others/utils.py stage-glue names re-exported lazily (the io module
    imports compat for the keypoint converters)."""
    from tpu3drec_torch.io import batch_pickle as bp
    return bp


def load_images(image_paths):
    """others/utils.py:515-533 equivalent."""
    return _stage_glue().load_images(image_paths)


def serializable_to_keypoints(serializable_kps, desc=None, image_shape=(),
                              device=None):
    """others/utils.py:540-563 equivalent (a Features on `device`)."""
    return _stage_glue().serializable_to_keypoints(
        serializable_kps, desc=desc, image_shape=image_shape, device=device)


def check_dependencies() -> Dict[str, bool]:
    """FME/__init__.py:336+ equivalent: the port's dependencies, and
    whether a CUDA card is visible."""
    out = {}
    for mod in ("torch", "numpy", "scipy"):
        try:
            __import__(mod)
            out[mod] = True
        except ImportError:
            out[mod] = False
    try:
        import torch
        out["cuda"] = bool(torch.cuda.is_available())
    except ImportError:
        out["cuda"] = False
    return out
