"""What a kernel wrapper needs at each launch, taken cheaply: the tensor's
device made current only when it is not already, and the raw handle of
that device's current stream (an int, with no ``torch.cuda.Stream``
built around it).
"""

from __future__ import annotations

import torch

__all__ = ["on_device"]


def on_device(device, launch):
    """``launch(stream)`` with ``device`` (a CUDA ``torch.device`` with an
    index) current and ``stream`` the raw handle of its current stream; a
    device context is entered only when another device is current."""
    idx = device.index
    if idx == torch.cuda.current_device():
        return launch(torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return launch(torch._C._cuda_getCurrentRawStream(idx))
