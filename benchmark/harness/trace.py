"""The traced run's profile: one steady sub-window of the measured window.

``torch.profiler`` records the card's kernels and copies and the host's
ops over a sub-window that opens a little into the closed loop, while
the clients keep sending.  The profiler has dropped device records at a
window's edges (the first two of a profile, and those whose span falls
outside it), so on every card the profile opens with ``LEAD_MARKERS``
marker kernels, waited for, and ``PAD_S`` of idle; the sub-window is the
span ``bench.window`` that the main thread opens after them, and every
device record is clipped to it.  Launch counts come from the program's
host counters, never from the number of device records.

Each request of the window runs inside a span ``bench.request.<text>``
on its client's thread; with the host ops that overlap them these name
the device's idle gaps in the breakdown.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

#: idle kept inside the profile before the markers and after the close
PAD_S = 0.05
#: marker kernels launched on every card when the profile opens
LEAD_MARKERS = 8
#: the sub-window opens this share of the window in, and lasts the same
#: share of it, at most ``LENGTH_MAX_S``
OFFSET_SHARE = 0.4
LENGTH_MAX_S = 6.0
#: entries of each list of the breakdown
TOP = 10

REQUEST_SPAN = "bench.request."
WINDOW_SPAN = "bench.window"


@dataclass
class TraceInfo:
    window: Tuple[float, float]                  # trace clock, us
    #: card index -> [(start us, end us, name)] of device records that
    #: overlap the window
    device: Dict[int, List[Tuple[float, float, str]]] = \
        field(default_factory=dict)
    #: [(text, start us, end us)] of the requests begun in the profile
    requests: List[Tuple[str, float, float]] = field(default_factory=list)
    #: [(name, start us, end us)] of the host's ops
    host: List[Tuple[float, float, str]] = field(default_factory=list)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self, card: int) -> List[Tuple[float, float]]:
        """The card's device records clipped to the window, merged."""
        w0, w1 = self.window
        spans = sorted((max(s, w0), min(e, w1))
                       for s, e, _n in self.device.get(card, ())
                       if e > w0 and s < w1)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_us(self, card: int) -> float:
        return sum(e - s for s, e in self.busy_intervals(card))

    def kernel_records(self, card: int, name: str):
        """(start, end) of the card's records whose name holds ``name``,
        wholly inside the window."""
        w0, w1 = self.window
        return [(s, e) for s, e, n in self.device.get(card, ())
                if name in n and s >= w0 and e <= w1]


def _all_threads():
    """The profiler's option to record every thread's ops (the clients'
    spans and the server's host ops), not only the thread that starts it."""
    from torch._C._profiler import _ExperimentalConfig
    return _ExperimentalConfig(profile_all_threads=True)


class Tracer:
    def __init__(self, devices, seconds: float):
        import torch
        self.devices = list(devices)
        self.offset_s = OFFSET_SHARE * seconds
        self.length_s = min(LENGTH_MAX_S, OFFSET_SHARE * seconds)
        self._markers = [torch.zeros(1, device=d) for d in self.devices]
        self._prof = None
        self.started = self.stopped = None      # perf_counter seconds

    @staticmethod
    def prime(devices) -> None:
        """One short profile before set-up captures any graph: CUPTI
        records the kernels of a CUDA graph only if it was running when
        the graph was built, and the first profile of a process keeps
        only the thread that started it."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if devices else [])
        with profile(activities=acts, experimental_config=_all_threads()):
            for d in devices:
                torch.zeros(1, device=d).fill_(1.0)
                torch.cuda.synchronize(d)

    def span(self, text: str):
        import torch
        return torch.profiler.record_function(REQUEST_SPAN + text)

    def _fill(self, n: int) -> None:
        import torch
        for d, m in zip(self.devices, self._markers):
            with torch.cuda.device(d):
                for _ in range(n):
                    m.fill_(1.0)

    def _sync(self) -> None:
        import torch
        for d in self.devices:
            torch.cuda.synchronize(d)

    def run(self, window_open: float) -> None:
        """Profile the sub-window (blocks the calling thread)."""
        from torch.profiler import ProfilerActivity, profile, record_function
        time.sleep(max(window_open + self.offset_s - time.perf_counter(), 0))
        acts = [ProfilerActivity.CPU]
        if self.devices:
            acts.append(ProfilerActivity.CUDA)
        self.started = time.perf_counter()
        self._prof = profile(activities=acts,
                             experimental_config=_all_threads())
        self._prof.start()
        time.sleep(PAD_S)
        self._fill(LEAD_MARKERS)
        self._sync()
        time.sleep(PAD_S)
        with record_function(WINDOW_SPAN):
            time.sleep(self.length_s)
        self._fill(1)
        self._sync()
        time.sleep(PAD_S)
        self._prof.stop()
        self.stopped = time.perf_counter()

    def overlaps(self, t0: float, t1: float) -> bool:
        """Whether a request issued at ``t0`` and answered at ``t1``
        (perf_counter seconds) ran while the profiler was on."""
        return self.started is not None and t0 < self.stopped \
            and t1 > self.started

    def analyze(self) -> TraceInfo:
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        events = self._prof.events()
        wins = [e for e in events if e.name == WINDOW_SPAN]
        if not wins:
            raise RuntimeError("the profile holds no window span")
        win = (wins[0].time_range.start, wins[0].time_range.end)
        info = TraceInfo(window=win)
        device = defaultdict(list)
        n_device, span = 0, [float("inf"), float("-inf")]
        for e in events:
            s, t = e.time_range.start, e.time_range.end
            if e.device_type == cuda:
                # the spans of record_function also show on the device's
                # timeline; they are no device work
                if e.name.startswith("bench."):
                    continue
                n_device += 1
                span = [min(span[0], s), max(span[1], t)]
                if t > win[0] and s < win[1]:
                    device[e.device_index].append((s, t, e.name))
            elif e.name.startswith(REQUEST_SPAN):
                info.requests.append((e.name[len(REQUEST_SPAN):], s, t))
            elif e.name != WINDOW_SPAN:
                info.host.append((s, t, e.name))
        info.device = {d.index: device.get(d.index, [])
                       for d in self.devices}
        print(f"[trace] window {info.window_us / 1e6:.3f} s: device records "
              f"by card {[len(v) for v in info.device.values()]}, "
              f"{len(info.requests)} request spans, {len(info.host)} host ops"
              f" on threads {sorted({e.thread for e in events})[:16]}; "
              f"{n_device} device records in all, over {span} us against the"
              f" window {list(win)}", file=sys.stderr, flush=True)
        return info

    def device_fields(self, info: TraceInfo) -> Dict[str, float]:
        """``busy_s`` (mean over the cards) and ``window_s``."""
        if not self.devices:
            return {}
        busy = sum(info.busy_us(c) for c in info.device) / len(info.device)
        return {"busy_s": busy / 1e6, "window_s": info.window_us / 1e6}

    def breakdown(self, info: TraceInfo) -> Dict[str, list]:
        """The device ops that took most time in the window (over every
        card), and the longest idle gaps, each named by the requests in
        flight and the host op whose calls overlap it longest."""
        w0, w1 = info.window
        by_name: Dict[str, float] = defaultdict(float)
        for recs in info.device.values():
            for s, e, n in recs:
                by_name[n[:120]] += (min(e, w1) - max(s, w0)) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = []
        for card in info.device:
            edge = w0
            for s, e in info.busy_intervals(card) + [(w1, w1)]:
                if s > edge:
                    gaps.append((s - edge, card, edge, s))
                edge = max(edge, e)
        gaps = sorted(gaps, reverse=True)[:TOP]
        named = []
        for length, card, g0, g1 in gaps:
            texts = sorted({t for t, s, e in info.requests
                            if s < g1 and e > g0})
            overlap: Dict[str, float] = defaultdict(float)
            for s, e, n in info.host:
                if e > g0 and s < g1:
                    overlap[n] += min(e, g1) - max(s, g0)
            best = max(overlap, key=overlap.get) if overlap else "no host op"
            named.append([f"card{card} {'+'.join(texts) or 'no request'}"
                          f" / {best[:80]}", length / 1e6])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
