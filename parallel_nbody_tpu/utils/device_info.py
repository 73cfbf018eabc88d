"""What a measurement ran on: the device as JAX reports it and the card's
power limit as ``nvidia-smi`` reports it.

A card set below its maximum power runs slower under load, so every number
this repository prints carries both.
"""

from __future__ import annotations

import subprocess


def card_power() -> str:
    """``name, power.limit`` of the first card from nvidia-smi, or
    ``"nvidia-smi unavailable"``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        return "nvidia-smi unavailable"
    return lines[0].strip()


def device() -> dict:
    """Platform, kind and count of JAX's devices."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
