"""The traced run: ``torch.profiler`` over the measured window, reduced
to what the per-layer readers take.

The raw Kineto events are read without building the profiler's event
tree. A device op (kernel, copy, set) is attributed to the benchmark's
span (``sample``, ``round_step``, ``observe_updates``) whose host interval
holds the op's start on the device: each span ends in a synchronise, so
its ops run inside it. Busy time is the union of device
intervals inside the window, the window running from the first measured
round's start to the last one's end; an idle gap is named by the span and
the innermost host operation running at its middle.
"""
from __future__ import annotations

import glob
from pathlib import Path

import numpy as np

SPANS = ("sample", "round_step", "observe_updates")
ROUND = "round"
METRICS = Path(__file__).resolve().parent / "metrics"


def activities():
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def patterns(metric: str) -> list[str]:
    """The device-op name fragments a roofline reads: every line of every
    ``metrics/<metric>.d/*.txt``."""
    out = []
    for path in sorted(glob.glob(str(METRICS / f"{metric}.d" / "*.txt"))):
        with open(path) as f:
            out += [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    return out


class Trace:
    """Device ops, host ops and spans of one traced window (ns, one clock)."""

    def __init__(self, events):
        from torch.autograd import DeviceType

        dev_rows, host_rows = [], []
        spans = {name: [] for name in SPANS + (ROUND,)}
        for e in events:
            start, dur = e.start_ns(), e.duration_ns()
            name = e.name()
            if e.device_type() == DeviceType.CPU:
                if name in spans:
                    spans[name].append((start, start + dur))
                    continue
                host_rows.append((start, start + dur, name))
            elif name in spans or getattr(e, "is_user_annotation", lambda: False)():
                continue  # a span's mirror on the device's timeline, not an op
            elif "Sync" not in name:  # CUPTI's synchronisation records are waits, not work
                dev_rows.append((start, start + dur, name))
        rounds = sorted(spans.pop(ROUND))
        if not rounds:
            raise RuntimeError("no measured round in the trace")
        self.t0, self.t1 = rounds[0][0], rounds[-1][1]
        self.window_s = (self.t1 - self.t0) / 1e9
        flat = sorted((a, b, k) for k, v in spans.items() for a, b in v)
        self._sp_start = np.array([a for a, _, _ in flat], dtype=np.int64)
        self._sp_end = np.array([b for _, b, _ in flat], dtype=np.int64)
        self._sp_name = [k for _, _, k in flat]
        dev_rows = [r for r in dev_rows if r[1] > self.t0 and r[0] < self.t1]
        self.dev_start = np.array([max(r[0], self.t0) for r in dev_rows], dtype=np.int64)
        self.dev_end = np.array([min(r[1], self.t1) for r in dev_rows], dtype=np.int64)
        self.dev_name = [r[2] for r in dev_rows]
        self.dev_span = self._spans_at(self.dev_start)
        self.host_start = np.array([r[0] for r in host_rows], dtype=np.int64)
        self.host_end = np.array([r[1] for r in host_rows], dtype=np.int64)
        self.host_name = [r[2] for r in host_rows]
        self.busy = self._union(np.ones(len(dev_rows), dtype=bool))

    def _spans_at(self, ts: np.ndarray) -> list:
        """The span holding each host time (None where none does, or t < 0)."""
        idx = np.searchsorted(self._sp_start, ts, side="right") - 1
        ok = (idx >= 0) & (ts >= 0)
        ok[ok] &= ts[ok] <= self._sp_end[idx[ok]]
        return [self._sp_name[i] if good else None for i, good in zip(idx.tolist(), ok.tolist())]

    def _union(self, mask) -> list:
        order = np.argsort(self.dev_start[mask], kind="stable")
        starts, ends = self.dev_start[mask][order], self.dev_end[mask][order]
        out = []
        for a, b in zip(starts.tolist(), ends.tolist()):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def mask(self, names=None, span=None):
        """Device ops whose name holds one of ``names`` and/or that ran in ``span``."""
        m = np.ones(len(self.dev_name), dtype=bool)
        if names is not None:
            m &= np.array([any(p in n for p in names) for n in self.dev_name], dtype=bool)
        if span is not None:
            m &= np.array([s == span for s in self.dev_span], dtype=bool)
        return m

    def op_seconds(self, names) -> tuple[float, int]:
        """(device seconds, count) of the ops whose name holds one of
        ``names``: the union of their intervals, so two that overlap (a
        kernel that waits on the one before it) count once."""
        m = self.mask(names)
        return self.busy_seconds(m), int(m.sum())

    def busy_seconds(self, mask) -> float:
        return sum(b - a for a, b in self._union(mask)) / 1e9

    def top_ops(self, k: int = 10) -> list:
        tot = {}
        for n, a, b in zip(self.dev_name, self.dev_start.tolist(), self.dev_end.tolist()):
            tot[n] = tot.get(n, 0) + (b - a)
        return [[n, v / 1e9] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        out = []
        for length, start in sorted(gaps, reverse=True)[:k]:
            mid = start + length // 2
            span = self._spans_at(np.array([mid], dtype=np.int64))[0] or "between spans"
            out.append([f"{span}: {self._host_at(mid)}", length / 1e9])
        return out

    def _host_at(self, t) -> str:
        cover = (self.host_start <= t) & (self.host_end >= t)
        if not cover.any():
            return "host code between ops"
        idx = np.flatnonzero(cover)
        return self.host_name[int(idx[np.argmax(self.host_start[idx])])]
