"""Resolve a cell of ``BENCHMARK.json`` to its files, by name.

A cell names a configuration and a traffic mix; the configuration's file
names its driver.  End-to-end metrics apply to a cell unless their
``workloads`` leave it out; a per-layer metric applies to the cells its
``workloads`` list, or without the key to every cell that reports the
end-to-end metric it moves.  A name with no file raises ``LookupError``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

from .spans import Spans

ROOT = Path(__file__).resolve().parents[1]


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def _json(here: Path, kind: str, name: str) -> dict:
    path = here / kind / f"{name}.json"
    if not path.is_file():
        raise LookupError(f"no {kind} file for {name!r}: {path}")
    return json.loads(path.read_text())


def load_module(here: Path, kind: str, name: str) -> ModuleType:
    """The module ``<kind>/<name>.py`` of the benchmark's folder, loaded by
    path (a metric's name may hold dots)."""
    path = here / kind / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no {kind} reader for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"svbench.{kind}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _merge(base: dict, extra: Optional[dict]) -> dict:
    out = dict(base)
    out.update(extra or {})
    return out


@dataclass
class Spec:
    workload: dict
    chips: int
    config: dict = field(default_factory=dict)
    traffic: dict = field(default_factory=dict)
    driver: Optional[ModuleType] = None
    end_to_end: List[dict] = field(default_factory=list)
    layer_metrics: List[dict] = field(default_factory=list)
    e2e_readers: Dict[str, ModuleType] = field(default_factory=dict)
    layers: Dict[str, ModuleType] = field(default_factory=dict)


def resolve(bench: dict, workload: str, load: bool = True,
            overrides: Optional[dict] = None, root: Path = ROOT) -> Spec:
    """The cell ``workload`` of ``bench`` with its files, found under
    ``root`` (the checkout); ``load=False`` only finds the entry.
    ``overrides`` = {"config": {...}, "traffic": {...}} merges keys into
    the two files' contents."""
    here = Path(root) / "svbench"
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise LookupError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    spec = Spec(workload=w, chips=int(w["chips"]))
    if not load:
        return spec
    overrides = overrides or {}
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise LookupError(f"no configuration {w['config']!r}")
    path = Path(root) / configs[w["config"]]["file"]
    if not path.is_file():
        raise LookupError(f"no configuration file {path}")
    spec.config = _merge(json.loads(path.read_text()),
                         overrides.get("config"))
    spec.traffic = _merge(_json(here, "traffic", w["traffic"]),
                          overrides.get("traffic"))
    spec.driver = load_module(here, "drivers", spec.config["driver"])
    spec.end_to_end = [m for m in bench["end_to_end"]
                       if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in spec.end_to_end}
    spec.layer_metrics = [
        m for m in bench["per_layer"]
        if (workload in m["workloads"] if "workloads" in m
            else m["moves"] in reported)]
    spec.e2e_readers = {m["name"]: load_module(here, "end_to_end",
                                               m["name"])
                        for m in spec.end_to_end}
    spec.layers = {m["name"]: load_module(here, "layers", m["name"])
                   for m in spec.layer_metrics}
    return spec


class Run:
    """What one run measured, as the metric readers see it: ``frames``
    completed and ``attempted`` in the window, each completed frame's
    latency in seconds, the window's and the set-up's seconds, the
    program's counters over the window, the host ``spans`` (traced runs),
    the ``device_trace`` (traced runs on the card), and the cell's
    ``config`` and ``traffic``."""

    def __init__(self, spec: Spec):
        self.spec = spec
        self.config, self.traffic = spec.config, spec.traffic
        self.spans = Spans()
        self.setup_s = self.window_s = 0.0
        self.frames = self.attempted = 0
        self.latencies: List[float] = []
        self.counters: Dict[str, int] = {}
        self.device_trace = None
