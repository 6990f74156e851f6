"""Folder sharding over processes and hosts (`torch.distributed`).

Port of `tpu3drec/parallel/multihost.py`. One process a card, on one
host or many: `init_multihost` joins the default process group (NCCL
between cards, gloo on the CPU), the FOLDER is split by pair index
across the processes (each matches its slice and writes
reference-format batch pickles, `results_p{pid}_batch_*.pkl` under
`shard_{pid}`), and global statistics are summed with a collective.

The batch pickles double as the merge format: `load_and_validate_pickle`
reads each shard's files, so the SfM stage does not see how many
processes produced them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpu3drec_torch.parallel.mesh import all_gather_cat, rank_device


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, device: str = "cuda") -> None:
    """Join the default process group at `tcp://{coordinator_address}`
    (host:port of process 0) as rank `process_id` of `num_processes`:
    NCCL on the cards (each process on `cuda:{LOCAL_RANK % cards}`, made
    its current device), gloo when `device` is "cpu". Call once per
    process, before any collective."""
    backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(rank_device())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def shard_pairs(pairs: Sequence, num_processes: int,
                process_id: int) -> List:
    """Deterministic round-robin pair assignment (folder sharding by pair
    index): every process's work set stays stable as the folder grows."""
    return [p for i, p in enumerate(pairs)
            if i % num_processes == process_id]


def global_pair_stats(local_counts: Dict[str, float]) -> Dict[str, float]:
    """Per-process scalar stats summed over every process of the default
    group (an `all_gather` of the float32 vector in sorted key order,
    summed on the host). Outside an initialised group: the local stats."""
    keys = sorted(local_counts)
    vec = np.asarray([float(local_counts[k]) for k in keys], np.float32)
    if not (dist.is_available() and dist.is_initialized()):
        return {k: float(v) for k, v in zip(keys, vec)}
    dev = rank_device() if dist.get_backend() == "nccl" else "cpu"
    total = all_gather_cat(torch.from_numpy(vec).to(dev)[None])
    summed = total.cpu().numpy().sum(axis=0)
    return {k: float(v) for k, v in zip(keys, summed)}


def match_folder_sharded(folder, output_dir, num_processes: int,
                         process_id: int, pipeline=None,
                         **match_kwargs) -> Dict:
    """Run one process's shard of a folder matching job.

    Each process writes `shard_{pid}/results_p{pid}_batch_*.pkl` (the
    reference interchange schema) and its own progress file, so resuming
    and the merge both work per shard. Returns this process's summary
    with the group's summed totals under "global"."""
    from tpu3drec_torch.io.images import (
        create_pairs_from_metadata, scan_folder_metadata,
    )
    from tpu3drec_torch.pipelines.matching import FeatureProcessingPipeline

    pipe = pipeline or FeatureProcessingPipeline()
    metas = scan_folder_metadata(folder)
    mode = match_kwargs.pop("pair_mode", "consecutive")
    window = match_kwargs.pop("pair_window", 1)
    pairs = create_pairs_from_metadata(metas, mode, window)
    mine = shard_pairs(pairs, num_processes, process_id)
    shard_dir = Path(output_dir) / f"shard_{process_id}"
    summary = pipe.match_folder(
        folder, output_dir=shard_dir, pairs=mine,
        base_name=f"results_p{process_id}", **match_kwargs)
    st = summary.get("stats", {})
    local = {"pairs": float(len(mine)),
             "completed": float(st.get("completed", 0)),
             "total_matches": float(st.get("total_matches", 0))}
    summary["global"] = global_pair_stats(local)
    return summary
