"""Deep feature models: SuperPoint, DISK, ALIKED (the approximation and
the published n16 network) and the LightGlue matcher, as `nn.Module`s.

Port of `tpu3drec/models/`. The weights are the converted checkpoints the
JAX package reads: npz files in `WEIGHTS_DIR` (`TPU3DREC_WEIGHTS`, read
when this module is imported; default `~/.cache/tpu3drec/weights`),
carried into each module's `state_dict` by `models._params`. Without them
a deep detector is not registered and LightGlue falls back to kNN, as in
the reference.
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
