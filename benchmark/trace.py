"""The traced run's reader: profile a bounded stretch of the window with
``torch.profiler``, check that the trace kept every event, and reduce it
to what the per-layer metrics read.

A trace may lose events (on an H100 one trace kept the events of 16 calls
of 50, another of 43), and a reader that trusts a lossy trace finds no
events for a kernel, or too little busy time. So before anything is read
the trace is checked, and the stretch taken again when it fails, up to
the workload's number of tries:

- each kernel that a metric of the cell declares has as many events as
  the program's launch counters say it launched in the stretch (each
  counted wrapper's launches times that kernel's launches a call), less
  at most two (the tolerance of the port's own ``median_device_ms``);
- every device operation repeats with the stretch's rounds: its count is
  a multiple of the rounds (a train step, a served request), or for an
  operation that runs once a group of rounds (a metrics fetch), of the
  groups, less at most two, and less at most two events (or a thousandth
  of them) in all.

A stretch starts and ends with the device idle, so every event inside it
belongs to it. ``busy_s`` is the union of the device's intervals; only a
trace that passed the check gives it. When every try fails, ``take``
raises ``TraceLost`` with the counts, and the run prints no result.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

_SCOPED = re.compile(r"::(\w+)\s*[<(]")
_PLAIN = re.compile(r"^(?:void\s+)?(\w+)\s*[<(]")


def kernel_id(name: str) -> str:
    """The function name of a device kernel's demangled signature:
    ``void (anonymous namespace)::head_bwd_dx_kernel<__nv_bfloat16>(...)``
    -> ``head_bwd_dx_kernel``; other names unchanged. A template kernel's
    name begins with its return type, ``void``, which is not its name."""
    m = _SCOPED.search(name) or _PLAIN.match(name)
    return m.group(1) if m else name


class TraceLost(RuntimeError):
    """Every try lost events; the message gives the counts."""


@dataclasses.dataclass
class Event:
    name: str
    start_us: float
    end_us: float

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) / 1e6


@dataclasses.dataclass
class Trace:
    """One checked stretch: its device events, the host's spans of the
    harness, its rounds and groups, the launches of each counted wrapper
    in it, its host-clock length and the device's busy time, and the
    facts that the metrics' readers need (shapes, configuration)."""

    events: List[Event]
    spans: List[Event]
    rounds: int
    groups: int
    launches: Dict[str, int]
    window_s: float
    busy_s: float
    facts: Dict
    tries: int

    def by_kernel(self) -> Dict[str, List[Event]]:
        out = collections.defaultdict(list)
        for e in self.events:
            out[kernel_id(e.name)].append(e)
        return out

    def ms_per_call(self, kernels: Dict[str, Tuple[str, int]]
                    ) -> Optional[float]:
        """Device ms of one call of a wrapper whose kernels are
        ``kernels`` (kernel id -> (counted wrapper, launches a call)): per
        kernel the mean of the events found times its launches a call,
        summed. None when the stretch ran none of them."""
        found = self.by_kernel()
        total = 0.0
        for kid, (_wrapper, per_call) in kernels.items():
            events = found.get(kid)
            if not events:
                return None
            total += per_call * sum(e.seconds for e in events) / len(events)
        return 1e3 * total

    def breakdown(self, top: int = 10) -> Dict:
        """The device operations that took most time, and the longest idle
        stretches by the harness span the host was in, seconds each."""
        ops = collections.Counter()
        for e in self.events:
            ops[e.name[:160]] += e.seconds
        gaps = collections.Counter()
        merged = _merged(self.events)
        for (_, end), (start, _) in zip(merged, merged[1:]):
            mid = 0.5 * (end + start)
            where = next((s.name for s in self.spans
                          if s.start_us <= mid <= s.end_us),
                         "host outside the harness's spans")
            gaps[where] += (start - end) / 1e6
        return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
                "idle_gaps": [[k, v] for k, v in gaps.most_common(top)]}


def _merged(events: List[Event]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for e in sorted(events, key=lambda e: e.start_us):
        if out and e.start_us <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e.end_us)
        else:
            out.append([e.start_us, e.end_us])
    return [(a, b) for a, b in out]


def busy_seconds(events: List[Event]) -> float:
    return sum(b - a for a, b in _merged(events)) / 1e6


def check(events: List[Event], rounds: int, groups: int,
          expected: Dict[str, int]) -> Optional[str]:
    """None if the trace kept every event, else what it lost."""
    if not events:
        return "no device events"
    ids = collections.Counter(kernel_id(e.name) for e in events)
    short = {k: (ids.get(k, 0), n) for k, n in expected.items()
             if not n - 2 <= ids.get(k, 0) <= n}
    if short:
        return (f"declared kernels (found, launched): {short}; kernels "
                f"found, by count: {dict(ids.most_common(40))}")
    names = collections.Counter(e.name for e in events)
    shorts = {n: _short(c, rounds if c >= rounds - 2 else groups)
              for n, c in names.items()}
    ragged = {n[:80]: names[n] for n, k in shorts.items() if k}
    if (max(shorts.values()) > 2
            or sum(shorts.values()) > max(2, 1e-3 * len(events))):
        return (f"operations whose count falls short of a multiple of the "
                f"{rounds} rounds or {groups} groups: {ragged}")
    return None


def _short(count: int, unit: int) -> int:
    """Events missing from ``count`` to the next multiple of ``unit``."""
    return -count % unit


def expected_events(declared: Dict[str, Tuple[str, int]],
                    launches: Dict[str, int]) -> Dict[str, int]:
    """Each declared kernel's events, from its wrapper's launches."""
    return {kid: launches.get(wrapper, 0) * per_call
            for kid, (wrapper, per_call) in declared.items()}


def record(stretch: Callable[[], None]
           ) -> Tuple[List[Event], List[Event], float]:
    """Profile ``stretch()`` on the card: (device events, the harness's host
    spans, the stretch's host-clock seconds, to the device's last work)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stretch()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events, spans = [], []
    for e in prof.events():
        rec = Event(e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                events.append(rec)
        elif e.name.startswith("bench."):
            spans.append(rec)
    return events, spans, window_s


def take(stretch: Callable[[], None], rounds: int, groups: int,
         declared: Dict[str, Tuple[str, int]],
         launch_counts: Callable[[], Dict[str, int]], tries: int,
         facts: Dict, log: Callable[[str], None],
         recorder: Callable = record) -> Trace:
    """Profile ``stretch()`` (``rounds`` rounds in ``groups`` groups, ending
    with the device idle) until a trace passes ``check``, at most
    ``tries`` times; raise ``TraceLost`` when none does. ``recorder``
    profiles one stretch (``record``; a test gives a fake)."""
    seen = []
    for attempt in range(1, tries + 1):
        before = launch_counts()
        events, spans, window_s = recorder(stretch)
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        lost = check(events, rounds, groups,
                     expected_events(declared, launches))
        busy = busy_seconds(events) if events else 0.0
        if lost is None and not 0.0 < busy <= window_s:
            lost = f"busy {busy} s outside (0, window {window_s} s]"
        if lost is None:
            log(f"trace {attempt}/{tries}: {len(events)} device events in "
                f"{rounds} rounds, busy {busy:.6f} s of {window_s:.6f} s")
            return Trace(events, spans, rounds, groups, launches, window_s,
                         busy, facts, attempt)
        log(f"trace {attempt}/{tries} lost events, taken again: {lost}")
        seen.append(lost)
    raise TraceLost(f"{tries} traces of the stretch lost events: {seen}")
