"""Crash-safe batch checkpointing: progress.json written after every pair.

Port of `tpu3drec/io/checkpoint.py`'s `BatchProcessor`: the completed-pair
set persisted as JSON after every unit of work, resume skips completed
pairs, a corrupted checkpoint starts fresh, plus the module-level helpers
load_progress / delete_progress / get_remaining_pairs. The file is the
reference's, so either package resumes the other's folder run. Writes are
atomic (tmp file + rename).

The reference's orbax reconstruction checkpoint is not ported: orbax is a
JAX library (ROADMAP Queue 1 #3). `Reconstruction.save_state` (the state
pickle) is the port's checkpoint.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

PROGRESS_FILE = "progress.json"

PairKey = Tuple[str, str]


def _key_str(pair: PairKey) -> str:
    return f"{pair[0]}|{pair[1]}"


class BatchProcessor:
    """Pair-completion checkpoint manager."""

    def __init__(self, output_dir, metadata: Optional[Dict] = None):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.progress_path = self.output_dir / PROGRESS_FILE
        self.completed: set = set()
        self.metadata: Dict = metadata or {}
        self._load()

    def _load(self) -> None:
        if not self.progress_path.exists():
            return
        try:
            data = json.loads(self.progress_path.read_text())
            self.completed = set(data.get("completed_pairs", []))
            self.metadata.update(data.get("metadata", {}))
        except (json.JSONDecodeError, OSError):
            # corrupted checkpoint -> start fresh
            self.completed = set()

    def save_progress(self) -> None:
        """Atomic write after every pair."""
        payload = {
            "completed_pairs": sorted(self.completed),
            "total_completed": len(self.completed),
            "last_updated": time.time(),
            "metadata": self.metadata,
        }
        tmp = self.progress_path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(payload, indent=1))
        os.replace(tmp, self.progress_path)

    def mark_completed(self, pair: PairKey, save: bool = True) -> None:
        self.completed.add(_key_str(pair))
        if save:
            self.save_progress()

    def is_completed(self, pair: PairKey) -> bool:
        return _key_str(pair) in self.completed

    def get_remaining_pairs(self, pairs: Sequence[PairKey]) -> List[PairKey]:
        return [p for p in pairs if not self.is_completed(p)]

    def reset(self) -> None:
        self.completed = set()
        if self.progress_path.exists():
            self.progress_path.unlink()

    @property
    def num_completed(self) -> int:
        return len(self.completed)


def load_progress(output_dir) -> Optional[Dict]:
    """The progress file's contents, or None if missing or corrupt."""
    p = Path(output_dir) / PROGRESS_FILE
    if not p.exists():
        return None
    try:
        return json.loads(p.read_text())
    except (json.JSONDecodeError, OSError):
        return None


def delete_progress(output_dir) -> bool:
    """Delete the progress file; True if there was one."""
    p = Path(output_dir) / PROGRESS_FILE
    if p.exists():
        p.unlink()
        return True
    return False


def get_remaining_pairs(output_dir, pairs: Sequence[PairKey]) -> List[PairKey]:
    """The pairs the progress file does not list as completed."""
    data = load_progress(output_dir)
    if not data:
        return list(pairs)
    done = set(data.get("completed_pairs", []))
    return [p for p in pairs if _key_str(p) not in done]
