"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the one given, else CUDA.

    Never falls back to the CPU: with no device given and no CUDA present this
    raises, so a run that was meant for the card cannot quietly run elsewhere.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available and no device was given; pass device='cpu' "
            "explicitly to run on the CPU"
        )
    return torch.device("cuda")
