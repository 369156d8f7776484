"""Least times from counted work, and the shares the per-layer metrics
read. Peaks of one NVIDIA H100 SXM from NVIDIA's data sheet (dense, 700 W):
HBM at 3.35 TB/s, 67 TFLOP/s in f32 outside the tensor cores."""

from __future__ import annotations

from typing import Optional

from . import manifest

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def least_time_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: each byte moved once at the
    memory rate, or each operation at the f32 peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def kernel_share(rec: dict, kernel: str) -> Optional[float]:
    """``kernel``'s share of its roofline over the traced span, in %: the
    least time of the calls it made there (their counted bytes and
    operations, ``counts/<kernel>.py``, per call of the cell's unit of
    work) over the device time of its kernels by name. None when the
    cell declares no such call or the trace holds none."""
    tr = rec.get("trace")
    calls = rec.get("work", {}).get("calls", {}).get(kernel)
    if not tr or not calls:
        return None
    cm = manifest.counts(kernel)
    k = tr["kernels"]
    n = sum(k[name]["count"] for name in cm.ENTRY if name in k)
    t = sum(k[name]["total_s"] for name in cm.KERNELS if name in k)
    if n == 0 or t <= 0:
        return None
    per_call = sum(least_time_s(*cm.count(c)) for c in calls) / len(calls)
    return 100.0 * n * per_call / t


def step_share(rec: dict) -> Optional[float]:
    """The whole step's share of the card's peak, in %: the least time of
    the work every implementation must do for one unit (``counts/step.py``)
    over the measured time per unit (the window over the units done; in a
    traced run the window holds the profiler's stop, 2-3 s of 40)."""
    step = rec.get("work", {}).get("step")
    if not step or not rec.get("units"):
        return None
    per_unit = least_time_s(*manifest.counts("step").count(step))
    return 100.0 * per_unit / (rec["window_s"] / rec["units"])


def device_idle_share(rec: dict) -> Optional[float]:
    """1 - busy / traced span, as a share in %."""
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def kernel_time_per_unit_ms(rec: dict, exclude: tuple, per: str):
    """Device ms per unit of every kernel not named in ``exclude``'s count
    modules, units counted by the launches of ``per``'s entry kernel."""
    tr = rec.get("trace")
    if not tr:
        return None
    names = set()
    for kern in exclude:
        names.update(manifest.counts(kern).KERNELS)
    entry = manifest.counts(per).ENTRY
    units = sum(tr["kernels"][n]["count"] for n in entry
                if n in tr["kernels"])
    if units == 0:
        return None
    t = sum(v["total_s"] for n, v in tr["kernels"].items() if n not in names)
    return 1e3 * t / units
