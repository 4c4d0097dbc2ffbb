"""The card a run measures: the check that it is there, its name, its
power limit and the published peaks its roofline shares are held to."""

from __future__ import annotations

import subprocess

# NVIDIA's data sheet, H100 SXM, dense rates, at the full 700 W
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "f32_flops_per_s": 67e12,
}


class NoDevice(RuntimeError):
    """The cell needs more cards than the machine has."""


def require_cuda(torch, chips):
    """Raise :class:`NoDevice` unless ``chips`` CUDA cards are visible."""
    if not torch.cuda.is_available():
        raise NoDevice("smcbench: torch.cuda.is_available() is False; the "
                       "benchmark measures the card and has no CPU path")
    have = torch.cuda.device_count()
    if have < chips:
        raise NoDevice(f"smcbench: the cell needs {chips} cards, "
                       f"torch.cuda.device_count() is {have}")


def power_limit():
    """``nvidia-smi``'s name and power limit of card 0, as one line
    (``"unknown"`` where it cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip() or "unknown"


def device_record(torch, device, chips):
    """The result line's ``device``: platform, kind, count and the peak of
    memory allocated on the card in the window (the harness resets the
    peak after set-up and reads it before the reference runs)."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
