"""Where the port runs: the card, unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``, raising when no card is visible; anything else
    is taken as given.  A CUDA device gets its index (the current one when
    none is named), so it compares equal to a tensor's device.  The port
    never drops to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device visible: the port runs on the GPU; pass "
                "device='cpu' to run it on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
