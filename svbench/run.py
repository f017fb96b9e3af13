"""Run one benchmark cell once and print its result line.

    python3 -m svbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Every run: check that the cells' cards are there (there is no CPU
fallback); build or load the program's kernels (their build directory,
``swiftvideo_tpu_torch/build/``, lies inside the checkout); make the cell's
inputs from ``--seed``; warm up the cell's own shapes; run the program in a
closed loop for ``--seconds``; check what it produced against the plain
reference in ``svbench/reference/``; print the numbers compared beside
their limits on standard error, then one JSON line on standard output.
With ``--trace 0`` the line's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from host-clock spans the
benchmark wraps around the program's functions and from torch.profiler's
device trace.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration ``svbench/configs/<config>.json`` (whose ``driver`` names a
module of ``svbench/drivers/``), the traffic ``svbench/traffic/<traffic>.json``,
each end-to-end metric's reader ``svbench/end_to_end/<name>.py`` and each
per-layer metric's reader ``svbench/layers/<name>.py``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    # run as a script: make the checkout's root importable
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from svbench import cells  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "swiftvideo_tpu")
TRACE_SECONDS = 10


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, taken whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


class Stages:
    """Seconds of each stage of the set-up, on the host clock, from the
    process's first line of the benchmark."""

    def __init__(self):
        self.last = T_START
        self.seconds: dict = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device=None, bench=None, overrides=None,
             root=cells.ROOT, stages=None) -> dict:
    """Run ``workload`` once on ``device`` (the card by default) and return
    the result's fields.  ``bench`` replaces BENCHMARK.json's contents,
    ``root`` the checkout its files are found in, and ``overrides`` merges
    keys into the configuration and the traffic (the CPU tests' tiny
    sizes).  ``stages`` times the set-up's stages."""
    import torch
    stages = stages or Stages()
    spec = cells.resolve(bench or cells.load_benchmark(), workload,
                         overrides=overrides, root=root)
    device = torch.device(device or "cuda")
    cuda = device.type == "cuda"
    if cuda:
        torch.empty(1, device=device)
        torch.cuda.synchronize()
    stages.mark("card")
    import swiftvideo_tpu_torch  # noqa: F401
    stages.mark("program_import")
    run = cells.Run(spec)
    if trace:
        for layer in spec.layers.values():
            for label, module, path in getattr(layer, "SPANS", ()):
                run.spans.wrap(label, module, path)
    cell = spec.driver.Cell(spec.config, spec.traffic, seed, device,
                            run.spans if trace else None)
    if cuda:
        # the peak counts what the program holds from here on: the inputs
        # it is handed and its own state, not the scratch of drawing them
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    stages.mark("inputs")
    cell.warm()
    if cuda:
        torch.cuda.synchronize()
    stages.mark("warm")
    run.setup_s = time.perf_counter() - T_START
    dtrace = None
    if trace and cuda:
        from svbench.trace import DeviceTrace
        dtrace = DeviceTrace()
        dtrace.start()
    counters0 = cell.counters()
    run.spans.on = trace
    t0 = time.perf_counter_ns()
    end = t0 + int(seconds * 1e9)
    # the device trace covers the window's first TRACE_SECONDS: the
    # profiler's records of a longer one take minutes to read
    trace_end = t0 + int(min(seconds, TRACE_SECONDS) * 1e9)
    while True:
        now = time.perf_counter_ns()
        if dtrace is not None and not dtrace.stopped and now >= trace_end:
            dtrace.stop(t0, now)
        if now >= end:
            break
        cell.tick()
    t1 = time.perf_counter_ns()
    run.spans.on = False
    if dtrace is not None and not dtrace.stopped:
        dtrace.stop(t0, t1)
    run.window_s = (t1 - t0) / 1e9
    run.counters = {k: v - counters0.get(k, 0)
                    for k, v in cell.counters().items()}
    run.frames, run.attempted, run.latencies = (cell.frames, cell.attempted,
                                                cell.latencies)
    run.device_trace = dtrace
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    cell.release()
    checks = cell.check(torch.float32)
    metrics = {}
    for m in (spec.layer_metrics if trace else spec.end_to_end):
        reader = (spec.layers if trace else spec.e2e_readers)[m["name"]]
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": all(v <= lim for v, lim in checks.values()),
           "attempted": run.attempted,
           "failed": run.attempted - run.frames,
           "metrics": metrics, "device": dev}
    if dtrace is not None:
        dev["busy_s"] = dtrace.busy_s()
        dev["window_s"] = dtrace.window_s()
        out["breakdown"] = dtrace.breakdown(run.spans)
    out["setup"] = stages.seconds
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    stages = Stages()
    bench = cells.load_benchmark()
    chips = cells.resolve(bench, args.workload, load=False).chips
    import torch
    stages.mark("torch_import")
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"the cell asks for {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   bench=bench, stages=stages)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print("setup " + ", ".join(f"{k} {v:.3f} s"
                               for k, v in out["setup"].items()),
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
