"""The check must fail what it is there to catch, at a tiny size on the CPU.

* The control: the plain reference in bfloat16, the precision below the
  configurations' float32, put in the program's place, fails a number of
  every cell.
* Faults planted in the timed path under a whole run (everything but the
  look for a card): a step that leaves its output as it was, half of the
  batch left out, an answer altered where it is produced.  Each cell's
  faults are its driver's (``svbench/faults/<driver>.py``).  Each run must
  come out not correct.
"""

from __future__ import annotations

import pytest
import torch

from svbench import cells, control, run
from svbench.conftest import faults, plant, tiny

BENCH = cells.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 4099


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_check(workload):
    r = control.readings(workload, SEED, 0.5, "cpu",
                         overrides=tiny(workload))
    assert all(v <= r["limits"][k] for k, v in r["program"].items())
    assert any(v > r["limits"][k] for k, v in r["control"].items())


FAULTS = [(w, f) for w in CELLS for f in sorted(faults(w))]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    """The fault, planted in the program under a whole run, reads not
    correct."""
    plant(monkeypatch, faults(workload)[fault])
    out = run.run_cell(workload, SEED, 0.5, False, device="cpu",
                       overrides=tiny(workload))
    assert out["correct"] is False, out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = control.readings(workload, SEED, 2.0)
    assert all(v <= r["limits"][k] for k, v in r["program"].items())
    assert any(v > r["limits"][k] for k, v in r["control"].items())
