"""Parity of tpu3drec_torch.parallel.multihost (folder sharding by pair
index, summed statistics, per-shard batch pickles) with the JAX
package's, as `tests/test_multihost.py` drives it.

`shard_pairs` runs in this process against the reference's. The
collectives and `match_folder_sharded` run in one gloo world of 2 ranks
on the CPU (`torch_dist_worker.py`; the ranks join it through
`init_multihost` at a TCP address), on the 5-image folder of
`tests/test_pipeline_matching.py` at its SIFT settings: 7 pairs split
4/3 and the summed stats as in `test_multihost.py`; the shards' pairs
together are the folder's, and each pair's raw match counts equal the
unsharded run's within max(2, 2%) (the same images and matcher; only
the pairs' places in a batch move).
"""

import os
import socket
import sys

import pytest
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_pipeline_matching import make_folder                   # noqa: E402
from chip_smoke import raw_match_counts                          # noqa: E402
from torch_dist_worker import run_world                          # noqa: E402
from tpu3drec.parallel.multihost import shard_pairs as j_shard   # noqa: E402
from tpu3drec_torch.io.batch_pickle import (                     # noqa: E402
    load_and_validate_pickle,
)
from tpu3drec_torch.parallel.multihost import (                  # noqa: E402
    global_pair_stats, shard_pairs,
)
from tpu3drec_torch.pipelines.matching import create_pipeline    # noqa: E402

PRESET = "fast"
CONFIG = {"methods": ["SIFT"], "max_features": 512,
          "matcher_config": {"SIFT": "bf"}}


@pytest.fixture(scope="module")
def folder_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    folder = make_folder(tmp)
    (tmp / "world").mkdir()
    with socket.socket() as s:              # a free port for process 0
        s.bind(("localhost", 0))
        coordinator = f"localhost:{s.getsockname()[1]}"
    ranks = run_world(tmp / "world", 2, "multihost", {
        "coordinator": coordinator, "folder": str(folder),
        "out": str(tmp / "sharded"), "preset": PRESET, "config": CONFIG})
    pipe = create_pipeline(PRESET, CONFIG, device="cpu")
    raw = raw_match_counts(pipe)
    summary = pipe.match_folder(folder, tmp / "unsharded", batch_size=2)
    return tmp, ranks, raw, summary


def test_shard_pairs_matches_jax():
    for n_pairs in (0, 1, 7, 11):
        pairs = [(f"a{i}", f"b{i}") for i in range(n_pairs)]
        for nproc in (1, 2, 3, 4):
            shards = [shard_pairs(pairs, nproc, p) for p in range(nproc)]
            assert shards == [j_shard(pairs, nproc, p) for p in range(nproc)]
            assert sorted(sum(shards, [])) == sorted(pairs)


def test_global_pair_stats_outside_a_group_is_local():
    assert global_pair_stats({"b": 2.0, "a": 1}) == {"a": 1.0, "b": 2.0}


def test_two_process_collectives(folder_runs):
    _, ranks, _, _ = folder_runs
    assert sorted(r["mine"] for r in ranks) == [3, 4]
    for r in ranks:
        assert r["total"] == {"matches": 30.0, "pairs": 7.0}


def test_match_folder_sharded_matches_unsharded(folder_runs):
    tmp, ranks, raw, summary = folder_runs
    n_pairs = summary["stats"]["total_pairs"]
    assert n_pairs == 4 and summary["stats"]["completed"] == 4
    for r in ranks:
        assert r["global"]["pairs"] == n_pairs
        assert r["global"]["completed"] == n_pairs
        assert r["global"]["total_matches"] == sum(
            q["stats"]["total_matches"] for q in ranks)
    merged = {}
    for pid in range(2):
        data = load_and_validate_pickle(
            str(tmp / "sharded" / f"shard_{pid}" / f"results_p{pid}_batch_*.pkl"))
        assert not merged.keys() & data["matches_data"].keys()
        merged.update(data["matches_data"])
    ref = load_and_validate_pickle(
        str(tmp / "unsharded" / "results_batch_*.pkl"))["matches_data"]
    assert sorted(merged) == sorted(ref) and len(ref) == n_pairs
    sharded_raw = {p: c for r in ranks for p, c in r["raw"].items()}
    assert sorted(sharded_raw) == sorted(raw) == sorted(ref)
    for pair, counts in raw.items():
        for method, n in counts.items():
            assert n > 10, (pair, method, n)
            assert abs(sharded_raw[pair][method] - n) <= max(2, 0.02 * n), \
                (pair, method, sharded_raw[pair][method], n)
