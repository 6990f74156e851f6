"""Deep feature models: not ported yet (ROADMAP Queue 1 #6).

`weights_available` reports whether converted checkpoints are on disk, in
the directory the JAX package reads (`TPU3DREC_WEIGHTS`, default
`~/.cache/tpu3drec/weights`). The config's hardware adjustment and the
detector registry ask it before they name a deep detector.
"""

import os
from pathlib import Path

WEIGHTS_DIR = Path(os.environ.get(
    "TPU3DREC_WEIGHTS", Path.home() / ".cache" / "tpu3drec" / "weights"))


def weights_available(model: str = None) -> bool:
    if not WEIGHTS_DIR.exists():
        return False
    if model is None:
        return any(WEIGHTS_DIR.glob("*.npz"))
    return (WEIGHTS_DIR / f"{model}.npz").exists()
