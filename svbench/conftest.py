"""Tiny sizes for the CPU tests of the benchmark: every cell's driver runs
end to end on the CPU at the sizes its driver module gives (``tiny``),
found through the configuration's ``driver``, with the program's plain
composite in place of the card's kernel."""

import importlib
from pathlib import Path

from svbench import cells


def tiny(workload: str, bench=None, root=cells.ROOT) -> dict:
    """The overrides that shrink ``workload`` to a CPU test's size."""
    spec = cells.resolve(bench or cells.load_benchmark(), workload,
                         root=root)
    return spec.driver.tiny(spec.config, spec.traffic)


def faults(workload: str, bench=None, root=cells.ROOT) -> dict:
    """The faults that the check of ``workload`` must catch:
    ``svbench/faults/<driver>.py``'s ``FAULTS``."""
    spec = cells.resolve(bench or cells.load_benchmark(), workload,
                         root=root)
    return cells.load_module(Path(root) / "svbench", "faults",
                             spec.config["driver"]).FAULTS


def plant(monkeypatch, fault) -> None:
    """Replace the program's function or method by the faulty one that
    ``fault`` = (module, path, wrapper maker) makes of it."""
    module, path, make = fault
    owner = importlib.import_module(module)
    *outer, name = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))
