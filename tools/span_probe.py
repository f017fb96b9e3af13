"""Run one benchmark cell on a CUDA card with the port's span recorder off,
on, or on under the benchmark's traced run, and print one JSON line.

    python tools/span_probe.py --workload <cell> --seed <n> --seconds <s> \
        --mode off|recorder|traced
    python tools/span_probe.py --workload <cell> --seed <n> --seconds <s> \
        --mode alternate
    python tools/span_probe.py --mode sites

``off`` is the benchmark's untraced run (``svbench.run``); ``recorder``
the same run with the port's recorder (``core/spans.py``) on from before
the cell is built to after the window, so that the two give the
recorder's cost in ``frames_per_s``; ``traced`` the benchmark's
``--trace 1`` run, whose ``frames_per_s`` is read over the device trace's
window alone (``traced_frames_per_s``: the ticks the harness's spans show
there), since the trace's processing, inside the window, holds the loop.
Every mode reports the card's name and power limit, ``correct`` and the
process's peak resident memory.

``traced`` also reports the per-layer metrics and the device trace's
breakdown, and checks that the recorder's clock and the device trace's
clock agree: each host-to-device copy and frame-kernel launch the trace
recorded is tied, by its correlation id, to the CUDA runtime call that
made it, and that call, moved onto the host clock by the trace's
``host_offset_ns``, should lie inside the ``barriers.h2d`` or
``frame.launch`` span around it.  With no runtime records it falls back to
the causal bound: the k-th copy or launch starts on the card after the
k-th span that made one began.  It reports the share of the harness's
own ``feed`` and ``step`` spans (publishing a step's inputs, and the clock
step) that the port's outermost spans cover, and each span name's count,
total and self time a frame.

``alternate`` runs the cell's loop in one process with the recorder on
and off in turn, a second each, and gives the rate of each slice with the
recorder on over the mean of the two off slices around it: the recorder's
cost without the drift of the shared host between processes.

``sites`` times an instrumented site alone, a million times over: off
(the flag test) and on (``begin`` and ``end``), in ns a site.
"""

from __future__ import annotations

import argparse
import json
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from svbench import cells, run as svrun  # noqa: E402

# the span that makes each kind of device activity checked
SPAN_OF_ACTIVITY = {"barriers.h2d": "Memcpy HtoD",
                    "frame.launch": "frame_composite"}


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _inside(starts, ends, a, b):
    """For calls [a, b], the index of the span (sorted by start) that began
    last at or before a, and whether the call lies inside it."""
    k = np.searchsorted(starts, a, side="right") - 1
    ok = k >= 0
    kk = np.maximum(k, 0)
    return kk, ok & (a >= starts[kk]) & (b <= ends[kk])


def clock_check(run) -> dict:
    from torch.autograd import DeviceType
    trace, rec = run.device_trace, run.program
    off = trace.host_offset_ns
    calls, acts = {}, []
    for e in trace._prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            kind = next((k for k, v in SPAN_OF_ACTIVITY.items()
                         if v in name), None)
            if kind:
                acts.append((kind, e.correlation_id(), e.start_ns()))
        elif name.startswith("cu"):
            calls[e.correlation_id()] = (name, e.start_ns(),
                                         e.start_ns() + e.duration_ns())
    out = {}
    for kind in SPAN_OF_ACTIVITY:
        rows = rec._rows((kind,))
        order = np.argsort(rec.start[rows])
        starts, ends = rec.start[rows][order], rec.end[rows][order]
        mine = [a for a in acts if a[0] == kind]
        hit = [calls[c] for _k, c, _s in mine if c in calls]
        res = {"device_activities": len(mine), "runtime_calls": len(hit),
               "spans": int(len(starts)),
               "call_names": sorted({h[0] for h in hit})}
        if hit:
            a = np.array([h[1] for h in hit], np.int64) - off
            b = np.array([h[2] for h in hit], np.int64) - off
            k, ok = _inside(starts, ends, a, b)
            outside = np.maximum(np.maximum(starts[k] - a, b - ends[k]), 0)
            res.update(
                inside_share=float(ok.mean()),
                lead_ns_median=float(np.median(a - starts[k])),
                tail_ns_median=float(np.median(ends[k] - b)),
                span_ns_median=float(np.median(ends[k] - starts[k])),
                outside_ns_median=float(np.median(outside[~ok]))
                if (~ok).any() else 0.0)
        elif mine and len(starts):
            # the causal bound: the k-th activity starts after the k-th span
            dev = np.sort(np.array([s for _k, _c, s in mine], np.int64)) - off
            first = np.searchsorted(starts, dev[0], side="right") - 1
            n = min(len(dev), len(starts) - max(first, 0))
            lead = dev[:n] - starts[max(first, 0):max(first, 0) + n]
            res.update(causal_share=float((lead >= 0).mean()),
                       device_after_span_ns_median=float(np.median(lead)))
        out[kind] = res
    return out


def coverage(run) -> dict:
    """Of the harness's ``feed`` and ``step`` spans, the share the port's
    outermost spans cover, and those spans' names."""
    rec = run.program
    harness = sorted((a, b, n) for a, b, n in run.spans.timeline
                     if n in ("feed", "step"))
    if not harness:
        return {}
    hs = np.array([h[0] for h in harness], np.int64)
    he = np.array([h[1] for h in harness], np.int64)
    top = np.flatnonzero(rec.parent == -1)
    k, ok = _inside(hs, he, rec.start[top], rec.end[top])
    out = {}
    for label in ("feed", "step"):
        mask = np.array([h[2] == label for h in harness])
        total = int((he - hs)[mask].sum())
        sel = ok & mask[k]
        covered = int((rec.end[top] - rec.start[top])[sel].sum())
        names = sorted({rec.names[i] for i in rec.name[top][sel].tolist()})
        out[label] = {"s": total / 1e9, "covered_share": covered / total,
                      "names": names}
    both = sum(v["s"] for v in out.values())
    out["feed_and_step_covered_share"] = sum(
        v["s"] * v["covered_share"] for v in out.values()
        if isinstance(v, dict)) / both
    out["outside_spans"] = int((~ok).sum())
    return out


def traced_rate(run):
    """Frames a second over the device trace's window: the ticks the
    harness's spans (``step`` live, ``tick`` on the wall) show ending in
    it, times the window's frames a tick."""
    trace = run.device_trace
    ticks = sorted((a, b) for a, b, n in run.spans.timeline
                   if n in ("step", "tick"))
    if trace is None or not ticks:
        return None
    lo, hi = (t - trace.host_offset_ns for t in trace.window_ns)
    inside = sum(1 for _a, b in ticks if lo <= b <= hi)
    return inside * run.frames / len(ticks) / ((hi - lo) / 1e9)


def per_name(run) -> dict:
    """Each span name's [spans, total us, self us] a frame."""
    rec = run.program
    return {n: [rec.count(n) / run.frames, rec.total_ns(n) / 1e3 / run.frames,
                rec.self_ns(n) / 1e3 / run.frames]
            for n in sorted(set(rec.names[k] for k in set(rec.name.tolist())))}


def sites(n: int = 1_000_000) -> dict:
    """ns an instrumented site costs, off and on."""
    from swiftvideo_tpu_torch.core import spans
    out = {}
    for on in (False, True):
        if on:
            spans.start()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            span = spans.ON and spans.begin("site")
            if span:
                spans.end(span)
        out["on_ns" if on else "off_ns"] = (time.perf_counter_ns() - t0) / n
        spans.stop()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        pass
    out["empty_loop_ns"] = (time.perf_counter_ns() - t0) / n
    return out


def alternate(workload: str, seed: int, seconds: float,
              slice_s: float = 1.0, device: str = "cuda",
              overrides=None) -> dict:
    import statistics
    import torch
    from swiftvideo_tpu_torch.core import spans
    spec = cells.resolve(cells.load_benchmark(), workload,
                         overrides=overrides)
    cell = spec.driver.Cell(spec.config, spec.traffic, seed,
                            torch.device(device))
    cell.warm()
    rates = []
    end = time.perf_counter() + seconds
    while time.perf_counter() < end or len(rates) % 2 == 0:
        on = len(rates) % 2 == 1
        if on:
            spans.start()
        f0, t0 = cell.frames, time.perf_counter()
        while time.perf_counter() - t0 < slice_s:
            cell.tick()
        rates.append((cell.frames - f0) / (time.perf_counter() - t0))
        if on:
            spans.stop()
    ratios = [rates[k] / ((rates[k - 1] + rates[k + 1]) / 2)
              for k in range(1, len(rates) - 1, 2)]
    q = statistics.quantiles(ratios, n=4)
    return {"slices": len(rates), "off_median": statistics.median(rates[::2]),
            "on_median": statistics.median(rates[1::2]),
            "on_over_off_median": statistics.median(ratios),
            "on_over_off_q1_q3": [q[0], q[2]]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--seconds", type=float)
    p.add_argument("--mode", choices=("off", "recorder", "traced",
                                      "alternate", "sites"), required=True)
    args = p.parse_args(argv)
    if args.mode == "sites":
        print(json.dumps(dict(sites(), card=card())))
        return 0
    if args.mode == "alternate":
        print(json.dumps(dict(alternate(args.workload, args.seed,
                                        args.seconds),
                              workload=args.workload, card=card())))
        return 0
    runs = []
    base = cells.Run

    class Kept(base):
        def __init__(self, spec):
            super().__init__(spec)
            runs.append(self)

    cells.Run = Kept
    if args.mode == "recorder":
        from swiftvideo_tpu_torch.core import spans
        spans.start()
    out = svrun.run_cell(args.workload, args.seed, args.seconds,
                         args.mode == "traced")
    line = {"workload": args.workload, "seed": args.seed, "mode": args.mode,
            "card": card(), "correct": out["correct"]}
    if args.mode == "recorder":
        line["recorded_spans"] = len(spans.stop())
    r = runs[-1]
    line["frames_per_s"] = r.frames / r.window_s
    if args.mode == "traced":
        rec = getattr(r, "program", None)
        line["traced_frames_per_s"] = traced_rate(r)
        line.update(
            metrics={k: v["value"] for k, v in out["metrics"].items()},
            breakdown=out.get("breakdown"),
            program_spans=len(rec) if rec is not None else 0,
            program_bytes=int(sum(getattr(rec, c).nbytes for c in (
                "name", "start", "end", "parent", "step", "thread")))
            if rec is not None else 0)
        if rec is not None:
            line["coverage"] = coverage(r)
            line["per_frame"] = per_name(r)
            if r.device_trace is not None:
                line["clock"] = clock_check(r)
    line["max_rss_mb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1024
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
