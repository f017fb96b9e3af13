"""CPU tests of the per-layer metrics that read the program's own spans and
counters (``svbench/program.py``): a traced run reports them, an untraced
run leaves the program's recorder off, a program without a recorder gives
a traced run with those metrics absent and the rest as before, and the
program's spans join the timeline the device trace's idle gaps are
labelled from.

    python -m pytest svbench -q
"""

from __future__ import annotations

import numpy as np
import pytest

from svbench import cells, program, run
from svbench.conftest import tiny
from svbench.spans import Spans

BENCH = cells.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 91
PROGRAM_METRICS = {
    "core.self_ms", "stages.self_us", "stats.self_us", "barriers.pin_ms",
    "barriers.h2d_gbps", "audio_mixer.self_ms", "video_mixer.self_us",
    "video_mixer.uniform_miss_pct", "wall.self_us", "cells.self_us",
    "cells.launch_us"}
# read only on the card: the uploads' copies and the cell kernel's launches
CARD_ONLY = {"barriers.pin_ms", "barriers.h2d_gbps", "cells.self_us",
             "cells.launch_us"}


def _metrics_of(workload):
    return {m["name"] for m in cells.resolve(BENCH, workload).layer_metrics}


def test_the_program_metrics_are_entries():
    assert PROGRAM_METRICS <= {m["name"] for m in BENCH["per_layer"]}


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_the_program_metrics(workload):
    spans = program.recorder()
    out = run.run_cell(workload, SEED, 0.5, True, device="cpu",
                       overrides=tiny(workload))
    assert out["correct"] is True, out["checks"]
    assert not spans.ON
    want = (_metrics_of(workload) & PROGRAM_METRICS) - CARD_ONLY
    assert want
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert all(got[k] > 0 for k in want), got
    assert not (set(got) & CARD_ONLY)


@pytest.mark.parametrize("workload", CELLS)
def test_untraced_run_leaves_the_recorder_off(workload, monkeypatch):
    spans = program.recorder()
    monkeypatch.setattr(spans, "start", lambda: pytest.fail("started"))
    out = run.run_cell(workload, SEED, 0.3, False, device="cpu",
                       overrides=tiny(workload))
    assert out["correct"] is True
    assert not spans.ON and len(spans.stop()) == 0


@pytest.mark.parametrize("workload", CELLS)
def test_a_program_without_the_recorder(workload, monkeypatch):
    """An older program has no recorder: a traced run reads every other
    metric as before and leaves the program's out."""
    monkeypatch.setattr(program, "recorder", lambda: None)
    out = run.run_cell(workload, SEED, 0.3, True, device="cpu",
                       overrides=tiny(workload))
    assert out["correct"] is True
    got = set(out["metrics"])
    assert got and not (got & PROGRAM_METRICS)
    assert all(v["value"] > 0 for v in out["metrics"].values())


class _Trace:
    """A device trace's window, on a clock 1000 ns ahead of the host's."""
    host_offset_ns = 1000
    window_ns = (1000 + 100, 1000 + 400)


def _traced_run():
    r = type("Run", (), {})()
    r.spans, r.device_trace = Spans(), _Trace()
    r.spans.timeline.append((0, 500, "step"))
    return r


def test_program_spans_join_the_labelled_timeline(monkeypatch):
    spans = program.recorder()
    assert program.records(_traced_run()) is None   # the recorder is off
    # program spans at 150-250 and 300-600 ns: the harness's window is
    # 0-500, the trace's 100-400
    rec = spans.Records(["clock.step", "bus.append"], *(np.array(c) for c in (
        [0, 1], [150, 300], [250, 600], [-1, -1], [0, 0], [0, 0])), {})
    spans.start()
    monkeypatch.setattr(spans, "stop", lambda: rec)
    r = _traced_run()
    taken = program.records(r)
    assert len(taken) == 1 and taken.names[taken.name[0]] == "clock.step"
    assert r.spans.timeline == [(0, 500, "step"), (150, 250, "clock.step")]
    assert program.records(r) is taken
    monkeypatch.undo()
    spans.stop()
