"""The port's reference-surface compatibility layer
(tpu3drec_torch.compat) against the JAX package's (tpu3drec.compat):
every name of the reference's surface exists in the port, the reference
package's own exported names are a subset of the port's, and the shims
compute what the JAX shims compute on the same inputs.

Bars: the homography filter's inlier ratio within 0.05 and its
reprojection error within 0.1 px of the reference's (both packages run
SIFT and RANSAC on the same image; the draws differ); keypoint
(de)serialisation exact; a Poisson mesh's face count within 2%; the
point-cloud shims equal to 1e-5.
"""

import numpy as np
import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

import tpu3drec.compat as J
import tpu3drec_torch.compat as C

REF_NAMES = [
    # core data structures
    "FeatureData", "MatchData", "ScoreType", "MethodResult",
    "MatchingResult",
    # pipeline/config
    "FeatureProcessingPipeline", "create_pipeline", "get_default_config",
    "DEFAULT_CONFIG", "create_config_from_preset", "merge_configs",
    "validate_config", "save_config", "load_config",
    # image manager / batch processor
    "ImageCache", "BatchImageLoader", "FolderImageSource",
    "BatchProcessor", "load_progress", "delete_progress",
    "get_remaining_pairs", "create_pairs_from_metadata",
    "scan_folder_quick",
    # matchers
    "auto_select_matcher", "MatcherFactory", "MatcherCompatibilityManager",
    # converters / viz
    "MethodReconstructionData", "MultiMethodReconstruction",
    "save_for_reconstruction", "load_for_reconstruction",
    "visualize_matches_quick", "show_matches", "plot_method_comparison",
    "plot_visualization_data", "save_visualization",
    # utils
    "enhanced_filter_matches_with_homography", "adaptive_match_filtering",
    "calculate_reprojection_error", "keypoint_to_dict", "dict_to_keypoint",
    "keypoints_to_list", "list_to_keypoints",
    # detectors
    "SIFTDetector", "ORBDetector", "AKAZEDetector", "BRISKDetector",
    "HarrisCornerDetector", "GoodFeaturesToTrackDetector",
    "SuperPointDetector", "DISKDetector", "ALIKEDDetector",
    "create_traditional_detector", "MultiMethodFeatureDetector",
    "create_multi_detector",
]


def test_reference_names_resolve():
    missing = [n for n in REF_NAMES if not hasattr(C, n)]
    assert not missing, missing


def test_detector_shim_and_filter_roundtrip(test_image):
    det = C.create_traditional_detector("SIFT", max_features=256,
                                        device="cpu")
    f1 = det.detect(test_image)
    f2 = C.SIFTDetector(max_features=256, device="cpu").detect(
        np.roll(test_image, 3, axis=1))
    assert f1.capacity == 256
    m = C.match_features(f1, f2)
    fm, H, ratio = C.enhanced_filter_matches_with_homography(f1, f2, m)
    assert H is not None and ratio > 0.5
    err = C.calculate_reprojection_error(H, f1, f2, fm)
    assert err < 2.0

    # the reference's shims on the same image
    jf1 = J.create_traditional_detector("SIFT", max_features=256).detect(
        test_image)
    jf2 = J.SIFTDetector(max_features=256).detect(
        np.roll(test_image, 3, axis=1))
    jm = J.match_features(jf1, jf2)
    _, jH, jratio = J.enhanced_filter_matches_with_homography(jf1, jf2, jm)
    jerr = J.calculate_reprojection_error(jH, jf1, jf2, _)
    assert abs(ratio - jratio) < 0.05, (ratio, jratio)
    assert abs(err - jerr) < 0.1, (err, jerr)

    kps = C.keypoints_to_list(f1)
    back = C.list_to_keypoints(kps, device="cpu")
    assert back.capacity == len(kps)
    # the reference's cv2.KeyPoint convention: angle in degrees [0, 360)
    assert all(0.0 <= d["angle"] < 360.0 for d in kps)
    ours = np.asarray(f1.to_numpy()["angle"])
    rt = np.asarray(back.to_numpy()["angle"])
    dd = np.abs(((ours - rt) + np.pi) % (2 * np.pi) - np.pi)
    assert float(dd.max()) < 1e-5
    # the same dicts as the reference's converter on the same keypoints
    jkps = J.keypoints_to_list(f1.to_numpy())
    assert kps == jkps


def test_cpe_dense_class_surface():
    """CPE/DR class names a reference user reaches for exist and compute
    what the reference's compute."""
    for n in ("MainPosePipeline", "StereoMatcher", "PointCloudProcessor",
              "MeshGenerator", "Reconstruction", "Camera", "SfMConfig",
              "reconstruct_scene", "assess_reconstruction_quality",
              "DenseReconstructionPipeline", "run_dense_reconstruction",
              "InitializationPairSelector"):
        assert hasattr(C, n), n

    mg = C.MeshGenerator(device="cpu")
    rng = np.random.default_rng(0)
    v = rng.normal(size=(500, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    mesh = mg.create_mesh_poisson(v.astype(np.float32),
                                  v.astype(np.float32), resolution=36)
    jmesh = J.MeshGenerator().create_mesh_poisson(
        v.astype(np.float32), v.astype(np.float32), resolution=36)
    assert len(mesh[1]) > 100
    assert abs(len(mesh[1]) - len(jmesh[1])) <= 0.02 * len(jmesh[1])
    q = mg.analyze_mesh_quality(mesh)
    assert q["num_faces"] == len(mesh[1])
    assert mg.compare_meshes(mesh, mesh)["surface_area"]["ratio"] == 1.0
    sm = mg.smooth_mesh(mesh, iterations=1)
    assert len(sm[0]) == len(mesh[0])

    pcp = C.PointCloudProcessor(device="cpu")
    depth = np.full((32, 32), 5.0, np.float32)
    K = np.array([[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]], np.float32)
    pts, _ = pcp.depth_map_to_point_cloud(depth, K)
    jpts, _ = J.PointCloudProcessor().depth_map_to_point_cloud(depth, K)
    assert len(pts) > 500
    np.testing.assert_allclose(pts, jpts, atol=1e-5)
    nrm = pcp.estimate_normals(pts[:256], k=8)
    jnrm = J.PointCloudProcessor().estimate_normals(pts[:256], k=8)
    assert nrm.shape == (256, 3)
    np.testing.assert_allclose(np.abs(nrm), np.abs(jnrm), atol=1e-5)

    pipe = C.MainPosePipeline(use_iterative_refinement=True)
    assert pipe.config.use_iterative_refinement
    with pytest.raises(RuntimeError, match="CUDA"):
        C.PointCloudProcessor()            # device=None means CUDA


def test_reference_all_exports_covered():
    """Every name of the reference package's surface (FME/__init__.py:
    207-302, with the deep-learning extension) exists in the port's
    compat, and every public name of tpu3drec.compat is a name of
    tpu3drec_torch.compat."""
    names = [
        'FeatureProcessingPipeline', 'create_pipeline',
        'MatchingResult', 'MethodResult', 'ImagePairInfo',
        'ProcessingMetadata', 'save_for_reconstruction',
        'load_for_reconstruction', 'save_results_batch',
        'load_results_batch', 'export_summary_csv',
        'VisualizationData', 'ReconstructionData',
        'MethodReconstructionData', 'ResultConverter', 'VisualMatch',
        'FeatureData', 'MatchData', 'EnhancedDMatch', 'ScoreType',
        'MultiMethodFeatureData', 'MultiMethodMatchData',
        'ImageMetadata', 'ImageInfo', 'ImageSourceType', 'ImageCache',
        'BatchImageLoader', 'FolderImageSource',
        'create_pairs_from_metadata', 'analyze_batch_reuse',
        'estimate_batch_memory', 'scan_folder_quick', 'BatchProcessor',
        'load_progress', 'delete_progress', 'get_remaining_pairs',
        'SIFTDetector', 'ORBDetector', 'AKAZEDetector', 'BRISKDetector',
        'MultiMethodFeatureDetector', 'EnhancedBFMatcher',
        'EnhancedFLANNMatcher', 'auto_select_matcher', 'MatcherFactory',
        'plot_visualization_data', 'plot_method_comparison',
        'visualize_matches_quick', 'show_matches',
        'visualize_matches_with_scores', 'save_visualization',
        'visualize_keypoints_only', 'get_default_config',
        'create_config_from_preset', 'validate_size',
        'image_size_from_shape', 'resize_image', 'print_size_info',
        'enhanced_filter_matches_with_homography',
        'adaptive_match_filtering', 'calculate_reprojection_error',
        'keypoint_to_dict', 'dict_to_keypoint', 'keypoints_to_list',
        'list_to_keypoints', 'SuperPointDetector', 'ALIKEDDetector',
        'DISKDetector', 'get_version', 'get_available_methods',
        'check_dependencies',
    ]
    missing = [n for n in names if not hasattr(C, n)]
    assert not missing, missing
    ref_public = {n for n in dir(J) if not n.startswith("_")
                  and not type(getattr(J, n)).__name__ == "module"}
    assert ref_public <= set(dir(C)), sorted(ref_public - set(dir(C)))

    assert C.get_available_methods() == J.get_available_methods()
    deps = C.check_dependencies()
    assert deps["torch"] and deps["numpy"]
    assert deps["cuda"] == torch.cuda.is_available()
    assert C.validate_size(np.zeros((100, 100)))
    assert not C.validate_size(np.zeros((4, 4)))
    assert C.image_size_from_shape((480, 640)) == (640, 480)
    img = np.random.default_rng(3).uniform(0, 1, (300, 150)).astype(
        np.float32)
    small = C.resize_image(img, 128)
    assert max(small.shape) == 128
    np.testing.assert_allclose(small, J.resize_image(img, 128), atol=1e-6)
    d = C.EnhancedDMatch(0, 1, 100.0, "distance")
    assert 0 < d.as_confidence() < 1
    assert d.as_confidence() == J.EnhancedDMatch(0, 1, 100.0,
                                                 "distance").as_confidence()
