"""What the host did beside the window, to tell the program's own variance
from the machine's: once a second, this process's CPU use in % of one
core (all its threads; the window's host work is bound to one core by
the interpreter's lock), and at both ends the card's clocks and power
draw (``nvidia-smi``). Printed with a run's notes; no metric reads it.

The card's machine reads a synthetic ``/proc``: every core busy, no
steal, a load of 0 and a fixed clock in every second of every run, so the
machine's own load is not sampled.
"""

from __future__ import annotations

import os
import subprocess
import threading
import time
from typing import Dict, List, Optional

PERIOD_S = 1.0


def card_clocks() -> str:
    """The card's SM and memory clocks (MHz) and power draw (W), as
    ``nvidia-smi`` reads them now."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({type(e).__name__})"


class HostLoad:
    """Samples this process's CPU use once a second from :meth:`start` to
    :meth:`stop` in a daemon thread; :meth:`summary` gives the list."""

    def __init__(self, card: bool = False):
        self.card = card
        self.proc_cpu_pct: List[float] = []
        self.clocks: Dict[str, str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self.card:
            self.clocks["start"] = card_clocks()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        prev, prev_t = sum(os.times()[:2]), time.perf_counter()
        while not self._stop.wait(PERIOD_S):
            cur, now = sum(os.times()[:2]), time.perf_counter()
            self.proc_cpu_pct.append(
                round(100.0 * (cur - prev) / (now - prev_t), 1))
            prev, prev_t = cur, now

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
        if self.card:
            self.clocks["end"] = card_clocks()

    def summary(self) -> dict:
        return {"proc_cpu_pct": self.proc_cpu_pct,
                "card_sm_mem_mhz_power_w": self.clocks}
