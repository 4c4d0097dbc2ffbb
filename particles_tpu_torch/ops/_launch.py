"""What a kernel wrapper needs at each launch, taken cheaply: the tensor's
device made current only when it is not already, and the raw handle of
that device's current stream (an int, with no ``torch.cuda.Stream``
built around it); and the launch geometry of the one-launch scans.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["on_device", "coop_geometry"]


def on_device(device, launch):
    """``launch(stream)`` with ``device`` (a CUDA ``torch.device`` with an
    index) current and ``stream`` the raw handle of its current stream; a
    device context is entered only when another device is current."""
    idx = device.index
    if idx == torch.cuda.current_device():
        return launch(torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return launch(torch._C._cuda_getCurrentRawStream(idx))


def coop_geometry(query, part_words, device, what):
    """``(tile, cache_tiles, max_grid)`` of a one-launch scan (B1, B3, B6,
    ``csrc/coop_chunks.cuh``) on a CUDA ``device`` (default: the current
    one), from its library's geometry function ``query``.  A launch over N
    elements has ``G = ceil(N / chunk)`` blocks of ``chunk = tile *
    ceil(ceil(N / max_grid) / tile)`` elements each, kept in shared memory
    when ``chunk <= cache_tiles * tile``."""
    out = [ctypes.c_int() for _ in range(3)]
    device = torch.device("cuda", torch.cuda.current_device()
                          if device is None else torch.device(device).index)
    err = on_device(device, lambda stream: query(
        part_words, *[ctypes.byref(v) for v in out]))
    if err != 0:
        raise RuntimeError(f"{what}: no cooperative launch on this device: "
                           f"CUDA error {err}")
    return tuple(v.value for v in out)
