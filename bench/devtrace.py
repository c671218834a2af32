"""The device trace of a stretch of whole rounds, from ``torch.profiler``,
reduced to what the per-layer metrics and the ``breakdown`` read.

The traced window runs from the first to the last device activity of the
rounds whose launches were recorded: the work launched between the
profiler's start and stop. ``busy_s`` is the union of those activities'
intervals; the idle gaps are the spaces between them, each named by the
innermost host call (a CUDA runtime call: a launch, a copy, a
synchronisation) that was running when it began.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, List, Optional, Tuple


@dataclasses.dataclass
class Trace:
    device: List[Tuple[str, float, float]]  # (name, start us, end us), by start
    host: List[Tuple[str, float, float]]
    rounds: int  # whole rounds whose launches were recorded
    active_steps: int  # client local steps those rounds took (sum of their taus)
    export_s: float = 0.0  # seconds spent writing the chrome trace

    @property
    def window_s(self) -> float:
        if not self.device:
            return 0.0
        return (max(e for _, _, e in self.device) - self.device[0][1]) / 1e6

    def busy(self) -> List[Tuple[float, float]]:
        """The device's busy intervals (us), merged."""
        out: List[List[float]] = []
        for _, s, e in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def kernel_seconds(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """Total device seconds and count of the activities ``match`` names."""
        hits = [(e - s) for n, s, e in self.device if match(n)]
        return sum(hits) / 1e6, len(hits)

    def top_ops(self, n: int = 10) -> List[list]:
        by: dict = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        busy = self.busy()
        gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1]) for i in range(len(busy) - 1)),
                      reverse=True)[:n]
        return [[f"{self._host_at(t)}", g / 1e6] for g, t in gaps]

    def _host_at(self, t: float) -> str:
        """The innermost host call running at ``t``; between calls, the
        last one that had ended."""
        inner: Optional[Tuple[float, str]] = None
        last: Optional[Tuple[float, str]] = None
        for name, s, e in self.host:
            if s <= t <= e and (inner is None or e - s < inner[0]):
                inner = (e - s, name)
            elif e < t and (last is None or e > last[0]):
                last = (e, name)
        if inner is not None:
            return inner[1][:160]
        return "between host calls" if last is None else f"after {last[1][:150]}"

def collect(prof, rounds: int, active_steps: int, path: Optional[Path] = None) -> Trace:
    """A stopped ``torch.profiler.profile`` -> ``Trace``; with ``path``
    the chrome trace is written there too."""
    import time

    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        row = (ev.name, float(tr.start), float(tr.end))
        if ev.device_type == DeviceType.CUDA:
            device.append(row)
        else:
            host.append(row)
    device.sort(key=lambda r: r[1])
    export_s = 0.0
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        prof.export_chrome_trace(str(path))
        export_s = time.perf_counter() - t0
    return Trace(device=device, host=host, rounds=rounds, active_steps=active_steps,
                 export_s=export_s)

