"""Reading the traces that ``train --profile_dir`` writes (port of
``utils/traces.py``): ``torch.profiler``'s Chrome traces
(``{profile_dir}/epoch_{e}.pt.trace.json.gz``), where the JAX package reads
XLA's.

A torch trace holds complete (``"ph": "X"``) events with a category:
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` on the card's process (its
``pid`` the device index, its ``tid`` the stream), ``cpu_op`` and
``cuda_runtime`` on the host's. Ranges are not operations and are left out of
the busy unions and self times (they would cover everything under them):
``user_annotation`` / ``gpu_user_annotation`` (``record_function``, such as
the trainer's ``train_step``; :func:`program_times` reads them),
``python_function`` frames and the profiler's own ``Trace`` span.
"""
from __future__ import annotations

import collections
import glob
import gzip
import json

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
RANGE_CATS = frozenset({"user_annotation", "gpu_user_annotation"})
NON_OP_CATS = RANGE_CATS | {"python_function", "Trace"}


def is_op(e: dict) -> bool:
    return e.get("cat") not in NON_OP_CATS


def load_events(trace_dir: str):
    """Every complete event and the process names of every
    ``*.trace.json[.gz]`` under ``trace_dir``."""
    files = sorted(glob.glob(trace_dir + "/**/*.trace.json.gz", recursive=True)
                   + glob.glob(trace_dir + "/**/*.trace.json", recursive=True))
    if not files:
        raise FileNotFoundError(
            f"no *.trace.json[.gz] under {trace_dir!r}: did the traced epoch run? "
            "(--profile_epoch defaults to 2: a 1-epoch run never starts the trace)")
    pid_names: dict = {}
    events = []
    for f in files:
        opener = gzip.open if f.endswith(".gz") else open
        with opener(f, "rt") as fh:
            data = json.load(fh)
        for e in data.get("traceEvents", []):
            ph = e.get("ph")
            if ph == "M" and e.get("name") in ("process_name", "process_labels"):
                args = e.get("args", {})
                pid_names[e["pid"]] = " ".join(
                    filter(None, (pid_names.get(e["pid"]), args.get("name"), args.get("labels"))))
            elif ph == "X":
                events.append(e)
    return events, pid_names


def device_pids(pid_names: dict, events) -> set:
    """The card's processes: those with device events or named for a GPU;
    every process of a trace without them (a CPU run)."""
    dev = {e["pid"] for e in events if e.get("cat") in DEVICE_CATS}
    dev |= {p for p, name in pid_names.items() if "gpu" in str(name).lower()}
    return dev or {e["pid"] for e in events}


def union_us(spans) -> float:
    """Covered time of (start, end) intervals: their union, since nested and
    overlapping events would count twice in a sum."""
    spans.sort()
    total, cur_s, cur_e = 0.0, None, None
    for s, t in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def self_times(events, pids) -> tuple:
    """Self time (µs) and count of each operation on ``pids``, and the union
    busy time: ``({name: (self_us, n)}, busy_us)``. Events on one (pid, tid)
    track nest, so a sweep with a stack gives each interval to the innermost
    operation over it."""
    by_track = collections.defaultdict(list)
    for e in events:
        if e["pid"] in pids and is_op(e):
            ts = e.get("ts", 0)
            by_track[(e["pid"], e.get("tid", 0))].append(
                (ts, ts + e.get("dur", 0), e.get("name", "?")))
    agg = collections.defaultdict(lambda: [0.0, 0])
    busy_spans = []

    def close(stack):
        s, t, n, child = stack.pop()
        agg[n][0] += (t - s) - child
        agg[n][1] += 1
        if stack:
            stack[-1][3] += t - s

    for track in by_track.values():
        track.sort(key=lambda t: (t[0], -(t[1] - t[0])))  # a parent before its children
        stack = []
        for ts, te, name in track:
            busy_spans.append((ts, te))
            while stack and ts >= stack[-1][1]:
                close(stack)
            stack.append([ts, te, name, 0.0])
        while stack:
            close(stack)
    return {k: (v[0], v[1]) for k, v in agg.items()}, union_us(busy_spans)


def program_times(events, pids) -> dict:
    """The ``record_function`` ranges on ``pids`` by name: ``{name: (total_us,
    n)}``. On the card's process these are ``gpu_user_annotation`` spans,
    from the first kernel a range launched to the end of its last: the
    trainer's ``train_step`` row is the device time of a step, the torch
    counterpart of the JAX package's ``jit_<name>`` program spans."""
    agg: dict = {}
    for e in events:
        if e["pid"] in pids and e.get("cat") in RANGE_CATS:
            us, n = agg.get(e["name"], (0.0, 0))
            agg[e["name"]] = (us + e.get("dur", 0), n + 1)
    return agg


def step_program(progs: dict):
    """The train step among :func:`program_times`' rows: the ``step``-named
    row with the largest total. Returns ``(name, ms_per_call)`` or None."""
    rows = [(us, us / n, name) for name, (us, n) in progs.items() if "step" in name]
    if not rows:
        return None
    _, per_call, name = max(rows)
    return name, per_call / 1e3


def category_times(events, pids) -> dict:
    """Operation time and bytes by the trace's category on ``pids``:
    ``{cat: (total_us, total_bytes)}`` (``gpu_memcpy`` events carry their
    bytes), the torch counterpart of XLA's ``hlo_category`` buckets."""
    cats: dict = {}
    for e in events:
        if e["pid"] in pids and is_op(e):
            us, nbytes = cats.get(e.get("cat"), (0.0, 0))
            cats[e.get("cat")] = (us + e.get("dur", 0),
                                  nbytes + int(e.get("args", {}).get("bytes", 0)))
    return cats


def device_busy_ms(trace_dir: str) -> float:
    """The card's busy time (ms) in a trace: the union of its operations'
    intervals on the busiest device process (the busiest process of a CPU
    trace)."""
    events, pid_names = load_events(trace_dir)
    dev = device_pids(pid_names, events)
    intervals = collections.defaultdict(list)
    for e in events:
        if e["pid"] in dev and is_op(e):
            ts = e.get("ts", 0)
            intervals[e["pid"]].append((ts, ts + e.get("dur", 0)))
    busy = [union_us(spans) for spans in intervals.values()]
    return max(busy) / 1e3 if busy else 0.0
