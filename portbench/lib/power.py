"""The card's ``power.draw`` from one streaming ``nvidia-smi`` process
(``-lms``) for the whole run, each line stamped with the host clock as it
is read; ``mean_w(t0, t1)`` averages the samples inside a window.  One
process for the run keeps the sampler's own load off the window it
measures."""

from __future__ import annotations

import shutil
import subprocess
import threading
import time
from typing import List, Optional, Tuple


class PowerStream:
    def __init__(self, gpu: str, period_ms: int = 100):
        exe = shutil.which("nvidia-smi")
        if exe is None:
            raise RuntimeError("nvidia-smi not found: the card's power "
                               "cannot be read")
        self.samples: List[Tuple[float, float]] = []
        self._proc = subprocess.Popen(
            [exe, "--query-gpu=power.draw", "--format=csv,noheader,nounits",
             "-lms", str(period_ms), "-i", gpu],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self) -> None:
        for line in self._proc.stdout:
            t = time.perf_counter()
            try:
                self.samples.append((t, float(line.strip())))
            except ValueError:
                continue

    def mean_w(self, t0: float, t1: float) -> Tuple[Optional[float], int]:
        w = [p for t, p in self.samples if t0 <= t <= t1]
        return (sum(w) / len(w) if w else None), len(w)

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
        self._thread.join(timeout=10)
        self._proc.stdout.close()
