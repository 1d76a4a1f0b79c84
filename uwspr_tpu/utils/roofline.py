"""Roofline accounting for compiled decode programs (SURVEY §7.1.9).

XLA's own HLO cost analysis supplies per-program FLOPs and device-memory
bytes (``compiled.cost_analysis()``); dividing by a measured device time
and the card's peaks turns a program time into an attribution —
tensor-core-bound, HBM-bound, or dispatch/latency-bound — so perf work
aims at the actual limiter. bench.py prints the whole-program line.

Peaks live in one table keyed by JAX's ``device_kind``; a device that is
not in the table is an error, not a default.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Peaks:
    bf16_flops: float            # dense tensor-core bf16 FLOP/s
    tf32_flops: float            # dense tensor-core TF32 FLOP/s
    f32_flops: float             # non-tensor-core f32 FLOP/s
    hbm_bytes: float             # device-memory bytes/s
    source: str


# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the card's
# full 700 W power limit (a card set lower cannot hold its top clock).
_H100_SXM = Peaks(bf16_flops=989e12, tf32_flops=495e12, f32_flops=67e12,
                  hbm_bytes=3.35e12,
                  source="NVIDIA H100 SXM data sheet (dense, 700 W)")

PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def peaks_for(device_kind: str) -> Peaks:
    """Peaks of a device by its JAX ``device_kind``; raises for a kind
    the table does not know."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no roofline peaks for device kind {device_kind!r}; known: "
            f"{sorted(PEAKS)}") from None


@dataclass
class Roofline:
    flops: float                 # program total (XLA cost analysis)
    bytes_accessed: float
    seconds: float               # measured device time per execution
    flops_per_s: float
    bytes_per_s: float
    tensor_util: float           # vs the bf16 tensor-core peak
    hbm_util: float
    bound: str                   # "tensor" | "HBM" | "dispatch/latency"

    def line(self) -> str:
        return (f"{self.flops / 1e9:.2f} GFLOP, "
                f"{self.bytes_accessed / 1e6:.1f} MB @ {self.seconds * 1e3:.2f} ms"
                f" -> {self.flops_per_s / 1e12:.2f} TFLOP/s "
                f"({self.tensor_util * 100:.1f}% of bf16 tensor peak), "
                f"{self.bytes_per_s / 1e9:.1f} GB/s "
                f"({self.hbm_util * 100:.1f}% HBM) [{self.bound}-bound]")


def cost_of(compiled) -> tuple[float, float]:
    """(flops, bytes) from a jax compiled object's cost analysis."""
    ca = compiled.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0] if ca else {}
    return float(ca.get("flops", 0.0)), float(ca.get("bytes accessed", 0.0))


def analyze(flops: float, bytes_accessed: float, seconds: float,
            peaks: Peaks) -> Roofline:
    """Classify a measured interval. 'bound' is the larger utilization;
    if both are under 10% the interval is dominated by neither — small
    ops, kernel launches, or serialized scalar work (dispatch/latency)."""
    fps = flops / max(seconds, 1e-12)
    bps = bytes_accessed / max(seconds, 1e-12)
    tensor = fps / peaks.bf16_flops
    hbm = bps / peaks.hbm_bytes
    if max(tensor, hbm) < 0.10:
        bound = "dispatch/latency"
    elif tensor >= hbm:
        bound = "tensor"
    else:
        bound = "HBM"
    return Roofline(flops, bytes_accessed, seconds, fps, bps, tensor, hbm,
                    bound)


__all__ = ["Peaks", "PEAKS", "peaks_for", "Roofline", "cost_of", "analyze"]
