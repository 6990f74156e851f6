"""Device policy for the entry points that take host (numpy) images."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means CUDA. Without a card, only an explicit CPU request is
    honoured: a silent fall back to the CPU would hide a missing GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpu3drec_torch: CUDA is not available; pass device='cpu' to "
            "run the plain PyTorch versions of the kernels on the CPU")
    return dev
