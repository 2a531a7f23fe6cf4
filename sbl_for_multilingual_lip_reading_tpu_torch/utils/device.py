"""The device the port's entry points run on: the card unless the caller
asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device``, or CUDA when it is None.  A CUDA device without a card
    raises: nothing falls back to the CPU unless the caller passes it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card unless the caller "
                "asks for the CPU (device='cpu'; the CLI's --cpu)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
