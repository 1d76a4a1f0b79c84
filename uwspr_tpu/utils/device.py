"""The card a measurement runs on: checked, named, and its power limit read.

A measurement path that finds no GPU fails here instead of falling back to
the CPU, and every device number is printed beside the card's name and
power limit (a card set below its maximum runs slower under load).
"""

from __future__ import annotations

import subprocess


def require_gpu():
    """JAX's GPU devices; raises SystemExit when JAX has none."""
    import jax
    try:
        devices = jax.devices("gpu")
    except RuntimeError as e:
        raise SystemExit(f"no GPU visible to JAX ({e})") from None
    if not devices:
        raise SystemExit("no GPU visible to JAX")
    return devices


def device_summary(devices) -> dict:
    """platform, device_kind and count as JAX reports them."""
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` output, one line per card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


__all__ = ["require_gpu", "device_summary", "card_name_and_power_limit"]
