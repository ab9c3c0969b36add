"""Published peaks of each H100 part, keyed by the name the card gives.

A copy of ``chip_smoke.py``'s ``PEAKS`` and ``card_peaks`` (NVIDIA's data
sheets, at the part's full power limit): device memory bytes/s and float32
FLOP/s outside the tensor cores, the rate the port runs at (it turns TF32
off). A card this table does not know raises, so no share is taken from the
peaks of another part.
"""
from __future__ import annotations

import subprocess

PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),      # SXM5
    "NVIDIA H100 NVL": (3.9e12, 60e12),
    "NVIDIA H100 PCIe": (2.0e12, 51e12),
}


def card_peaks(name: str):
    """(bytes/s, fp32 FLOP/s) of the card ``name``."""
    if name not in PEAKS:
        raise KeyError(f"no published peaks for {name!r}: add its data "
                       "sheet's memory rate and fp32 rate to PEAKS")
    return PEAKS[name]


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them, or what
    went wrong in asking."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return (out.stdout.strip().splitlines() or [out.stderr.strip()])[0]
