"""The profiler's view of a traced stretch of a run.

:class:`Traced` runs ``torch.profiler`` (host ranges and device activity)
over a stretch of the window: one warm-up cycle first, whose events are
dropped, since events at the very start of a trace can be lost.  Its
:class:`Trace` holds the device intervals (kernels and copies, without the
device side of host ranges), the host ranges, and the traced window's
bounds, and computes busy time, the top device operations and the idle
gaps by the host range open across them.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

# idle seconds around a traced stretch that the run can pause for: without
# them the profiler has been seen to lose kernels at a trace's edges
MARGIN_S = 0.25


@dataclass
class Trace:
    device: list = field(default_factory=list)   # (name, start_us, end_us)
    host: list = field(default_factory=list)     # (name, start_us, end_us)
    window_s: float = 0.0                        # the traced stretch's wall seconds

    def named(self, fragment: str) -> list:
        """Device intervals whose name holds ``fragment`` (any case)."""
        f = fragment.lower()
        return [e for e in self.device if f in e[0].lower()]

    def merged(self) -> list[tuple[float, float]]:
        """The union of the device intervals, merged and in order."""
        out: list[list[float]] = []
        for s, e in sorted((s, e) for _, s, e in self.device):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e6

    def top_ops(self, n: int = 10) -> list:
        total: dict = {}
        for name, s, e in self.device:
            total[name] = total.get(name, 0.0) + (e - s) / 1e6
        return sorted(([k[:120], v] for k, v in total.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10, min_us: float = 20.0) -> list:
        """Idle seconds between device activity, by the innermost host range
        open at each gap's middle (``host: none`` where none was); gaps
        under ``min_us`` together as ``between kernels``."""
        merged = self.merged()
        hosts = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in hosts]
        total: dict = {}
        for (_, s), (e, _) in zip(merged, merged[1:]):
            if e - s < min_us:
                total["between kernels"] = total.get("between kernels", 0.0) + (e - s) / 1e6
                continue
            mid = (s + e) / 2
            i = bisect.bisect_right(starts, mid)
            open_ = [h for h in hosts[max(0, i - 2000):i] if h[2] >= mid]
            name = min(open_, key=lambda h: h[2] - h[1])[0] if open_ else "host: none"
            total[name] = total.get(name, 0.0) + (e - s) / 1e6
        return sorted(([k[:120], v] for k, v in total.items()), key=lambda kv: -kv[1])[:n]


def _all_threads():
    """The profiler's option to record host ranges on every thread (the
    serving front end's threads run the model), where torch has it."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


class Traced:
    """``with Traced() as t: ...`` profiles the block; ``t.trace`` after.
    ``margin_s``: idle seconds before and after it; ``sync``: wait for the
    device at both ends (a block that runs open-loop traffic cannot)."""

    def __init__(self, margin_s: float = 0.0, sync: bool = True):
        self.margin_s = margin_s
        self.sync = sync and torch.cuda.is_available()
        self._trace = self._done = self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, schedule

        if self.sync:
            torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                         else [])
        self._prof = profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                             on_trace_ready=self._ready, experimental_config=_all_threads())
        self._prof.__enter__()
        time.sleep(0.05)
        self._prof.step()  # warm-up cycle over: record from here
        time.sleep(self.margin_s)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            torch.cuda.synchronize()
        self._t1 = time.perf_counter()
        time.sleep(self.margin_s)
        self._prof.step()
        self._prof.__exit__(*exc)
        return False

    def _ready(self, prof) -> None:
        self._done = prof.profiler  # its events are parsed at first use

    @property
    def trace(self) -> Trace:
        """The stretch's :class:`Trace`, read from the profiler's events at
        first use (after the window, where that takes long)."""
        if self._trace is None:
            self._trace = self._read(self._done)
        return self._trace

    def _read(self, profiler) -> Trace:
        events = profiler.function_events
        host_names = set()
        host, device = [], []
        for e in events:
            rng = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == torch.autograd.DeviceType.CPU:
                host.append(rng)
                host_names.add(e.name)
        for e in events:
            if e.device_type != torch.autograd.DeviceType.CPU and e.name not in host_names:
                device.append((e.name, e.time_range.start, e.time_range.end))
        return Trace(device=device, host=host, window_s=self._t1 - self._t0)
