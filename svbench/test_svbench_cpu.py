"""CPU tests of the benchmark: cells resolve by name, traffic is a function
of the seed, the byte bounds match hand counts, the plain reference
matches hand-worked values, every cell's driver runs end to end at a tiny
size, and a cell can be added with new files only.

    python -m pytest svbench -q
"""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

from svbench import cells, run
from svbench.bounds import cell_kernel, frame_kernel
from svbench.conftest import faults, plant, tiny
from svbench.reference import audio as ref_audio
from svbench.reference import composite as ref_comp
from svbench.reference import scene as ref_scene

BENCH = cells.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 77


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_to_its_files(workload):
    spec = cells.resolve(BENCH, workload)
    assert spec.driver is not None and hasattr(spec.driver, "Cell")
    assert {m["name"] for m in spec.end_to_end} >= {"setup_s"}
    assert len(spec.end_to_end) >= 2 and spec.layer_metrics
    for m in spec.layer_metrics:
        assert m["moves"] in {e["name"] for e in spec.end_to_end}
        assert hasattr(spec.layers[m["name"]], "read")


@pytest.mark.parametrize("field,value", [
    ("workload", "no-such-cell"), ("config", "no_such_config"),
    ("traffic", "no_such_traffic"), ("layer", "no_such.metric")])
def test_unknown_name_fails(field, value):
    bench = json.loads(json.dumps(BENCH))
    name = CELLS[0]
    w = next(w for w in bench["workloads"] if w["name"] == name)
    if field == "workload":
        name = value
    elif field == "layer":
        bench["per_layer"].append({
            "name": value, "unit": "ms", "better": "lower",
            "source": "program_span", "layer": "x", "moves": "frames_per_s",
            "workloads": [name]})
    else:
        w[field] = value
    with pytest.raises(LookupError):
        cells.resolve(bench, name)


def _inputs(workload, seed, bench=BENCH, root=cells.ROOT):
    spec = cells.resolve(bench, workload, root=root,
                         overrides=tiny(workload, bench, root))
    return spec.driver.Cell(spec.config, spec.traffic, seed,
                            torch.device("cpu")).inputs()


def _same_for_the_same_seed(workload, bench=BENCH, root=cells.ROOT):
    a, b, c = (_inputs(workload, s, bench, root)
               for s in (SEED, SEED, SEED + 1))
    assert a and all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, z) for x, z in zip(a, c))


@pytest.mark.parametrize("workload", CELLS)
def test_traffic_is_a_function_of_the_seed(workload):
    _same_for_the_same_seed(workload)


def test_live_byte_bound_is_the_hand_count():
    config = json.loads((cells.ROOT / "svbench/configs/live1080.json")
                        .read_text())
    cam = 1920 * 1080 + 2 * 960 * 540
    assert frame_kernel.bytes_per_frame(config) == \
        4 * cam + 1920 * 216 * 4 + cam == 17_210_880


def _brute_sectors(in_w, in_h, out_w, out_h, sector=32):
    """Every output pixel's bilinear taps with a nonzero weight, one by
    one, as the sectors of the dense plane that hold them."""
    hit = set()
    for oy in range(out_h):
        y = oy / out_h * in_h - 0.5
        y0 = int(np.floor(y))
        rows = {min(max(y0, 0), in_h - 1)}
        if y - y0 > 0:
            rows.add(min(max(y0 + 1, 0), in_h - 1))
        for ox in range(out_w):
            x = ox / out_w * in_w - 0.5
            x0 = int(np.floor(x))
            cols = {min(max(x0, 0), in_w - 1)}
            if x - x0 > 0:
                cols.add(min(max(x0 + 1, 0), in_w - 1))
            hit.update((r * in_w + c) // sector for r in rows for c in cols)
    return len(hit)


@pytest.mark.parametrize("shape", [(192, 108, 24, 14), (200, 90, 24, 12),
                                   (64, 36, 64, 36), (96, 64, 40, 30)])
def test_wall_tap_sectors_against_brute_force(shape):
    assert cell_kernel.plane_sectors(*shape) == _brute_sectors(*shape)


def test_wall_byte_bound():
    config = json.loads((cells.ROOT / "svbench/configs/wall64.json")
                        .read_text())
    canvas = 1920 * 1088 * 3 // 2
    audio = 65 * 800 * 2 * 2
    taps = 64 * cell_kernel.stream_bytes((1920, 1080), (240, 136))
    assert cell_kernel.bytes_per_tick(config) == taps + canvas + audio
    # an 8:1 downscale reads every sector of each row it taps
    assert cell_kernel.plane_sectors(1920, 1080, 240, 136) == \
        cell_kernel.taps(1080, 136).size * 1920 // 32


def test_reference_composite_hand_values():
    """A 4x2 y420p source of constant luma 200 and chroma 60, 90 over the
    whole 4x2 canvas at opacity 0.5: every luma pixel round(200 / 2) = 100,
    chroma round((128 + 60) / 2) = 94 and round((128 + 90) / 2) = 109; at
    opacity 1 the canvas is the source."""
    src = [torch.full((2, 4), 200, dtype=torch.uint8),
           torch.full((1, 2), 60, dtype=torch.uint8),
           torch.full((1, 2), 90, dtype=torch.uint8)]
    half = ref_scene.FULL_CELL.__class__(
        **{**ref_scene.FULL_CELL.__dict__, "opacity": np.float32(0.5)})
    out = ref_comp.composite_y420p((4, 2), [(src, False, half)], "cpu")
    assert [t.unique().tolist() for t in out] == [[100], [94], [109]]
    out = ref_comp.composite_y420p((4, 2), [(src, False,
                                             ref_scene.FULL_CELL)], "cpu")
    assert all(torch.equal(a, b) for a, b in zip(out, src))


def test_reference_placement_of_a_quadrant():
    """The top-left quadrant of a 64x36 canvas: canvas pixel
    (ndc + 1) * 64 / 2 over the 32-pixel element is local ndc + 1, and
    likewise down the 18 rows."""
    p = ref_scene.placement(ref_scene.State(pos=(0.0, 0.0),
                                            size=(32.0, 18.0)), (64, 36))
    np.testing.assert_allclose(p.transform, [1, 0, 0, 1, 1, 1], atol=1e-6)
    assert p.opacity == np.float32(1.0)


def test_reference_audio_fold_hand_values():
    a = (np.array([100, -200, 30000, 30000], np.int16),
         np.array([0.5, 2.0], np.float32))
    b = (np.array([-7, 7, 3000, -3000], np.int16),
         np.array([1.5, 1.0], np.float32))
    # trunc(100 * 0.5) + trunc(-7 * 1.5) = 50 - 10; -400 + 7;
    # 15000 + 4500; trunc(30000 * 2) saturates to 32767, then - 3000
    assert ref_audio.fold_s16([a, b], 4).tolist() == \
        [40, -393, 19500, 29767]
    mix = ref_audio.wall_mix(torch.tensor([[30000, -5], [30000, -6]],
                                          dtype=torch.int16),
                             torch.ones(2))
    assert mix.tolist() == [32767, -11]


def test_reference_gains_of_a_stereo_source():
    g = ref_scene.channel_gains(ref_scene.State(pos=(0, 0), size=(1, 1),
                                                audio_gain=0.75), 2)
    assert g.dtype == np.float32 and g.tolist() == [0.75, 0.75]


def test_state_at_interpolates_and_holds():
    a = ref_scene.State(pos=(0.0, 0.0), size=(10.0, 10.0))
    b = ref_scene.State(pos=(0.0, 0.0), size=(20.0, 20.0), audio_gain=0.5)
    tr = [ref_scene.Transition(start=10, duration=4, to=b)]
    assert ref_scene.state_at(a, tr, 9) == a
    assert ref_scene.state_at(a, tr, 12).size == (15.0, 15.0)
    assert ref_scene.state_at(a, tr, 14) == b
    back = tr + [ref_scene.Transition(start=20, duration=4, to=a)]
    assert ref_scene.state_at(a, back, 22).audio_gain == 0.75


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_drives_end_to_end_on_the_cpu(workload, trace):
    out = run.run_cell(workload, SEED, 0.5, bool(trace), device="cpu",
                       overrides=tiny(workload))
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    if not trace:
        assert set(out["metrics"]) == {
            m["name"] for m in BENCH["end_to_end"]
            if workload in m.get("workloads", [workload])}
        assert all(v["value"] > 0 for v in out["metrics"].values())
    else:
        # the host spans' metrics; the device trace's need the card
        assert out["metrics"] and all(v["value"] > 0
                                      for v in out["metrics"].values())
    assert list(out)[-1] == "checks"


def _add_metric(root, bench, name, label):
    """A per-layer metric: calls of a host span a frame."""
    (root / f"svbench/layers/{name}.py").write_text(
        '"""Calls a frame."""\n\n'
        f'def read(run):\n    n = run.spans.calls("{label}")\n'
        '    return n / run.frames if n and run.frames else None\n')
    bench["per_layer"].append({"name": name, "unit": "calls",
                               "better": "lower", "source": "program_span",
                               "layer": "test", "moves": "frames_per_s",
                               "workloads": ["throwaway.cell"]})


def _add_live_cell(root, bench):
    """A configuration, a traffic mix and a per-layer metric for the live
    driver: a clock step a 10 ms of audio, 10 / 3 a 30 fps frame."""
    config = json.loads((root / "svbench/configs/live1080.json").read_text())
    config.update(name="throwaway")
    (root / "svbench/configs/throwaway.json").write_text(json.dumps(config))
    traffic = json.loads((root / "svbench/traffic/devcams.json").read_text())
    traffic.update(ring=3)
    (root / "svbench/traffic/throwaway_mix.json").write_text(
        json.dumps(traffic))
    _add_metric(root, bench, "throwaway.steps", "step")
    return "throwaway", "throwaway_mix", 10 / 3


def _add_new_kind(root, bench):
    """A configuration of a new kind: its own driver and faults modules
    (here the wall's under another name), a traffic mix and a per-layer
    metric: one tick a canvas."""
    config = json.loads((root / "svbench/configs/wall64.json").read_text())
    config.update(name="throwaway_kind", driver="throwaway_kind")
    (root / "svbench/configs/throwaway_kind.json").write_text(
        json.dumps(config))
    (root / "svbench/drivers/throwaway_kind.py").write_text(
        '"""A new kind of configuration."""\n'
        "from svbench.drivers.wall import Cell, tiny  # noqa: F401\n")
    (root / "svbench/faults/throwaway_kind.py").write_text(
        '"""Its faults."""\n'
        "from svbench.faults.wall import FAULTS  # noqa: F401\n")
    traffic = json.loads((root / "svbench/traffic/plan.json").read_text())
    (root / "svbench/traffic/throwaway_mix.json").write_text(
        json.dumps(traffic))
    _add_metric(root, bench, "throwaway.ticks", "tick")
    return "throwaway_kind", "throwaway_mix", 1


@pytest.mark.parametrize("add", [_add_live_cell, _add_new_kind],
                         ids=["live driver", "new driver"])
def test_a_cell_is_added_with_new_files_only(tmp_path, add, monkeypatch):
    """A throwaway cell: new files in a copy of the benchmark's folder and
    new BENCHMARK.json entries, no existing file edited.  The CPU tests'
    size, its inputs, its run and its faults are all found through it."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.ROOT / "svbench", root / "svbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "svbench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    config, mix, calls = add(root, bench)
    bench["configs"].append({"name": config, "source": "test",
                             "file": f"svbench/configs/{config}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "throwaway.cell", "config": config,
                               "traffic": mix, "chips": 1, "why": "test"})
    _same_for_the_same_seed("throwaway.cell", bench, root)
    small = tiny("throwaway.cell", bench, root)
    out = run.run_cell("throwaway.cell", SEED, 0.3, True, device="cpu",
                       bench=bench, root=root, overrides=small)
    assert out["correct"] is True, out["checks"]
    (value,) = (m["value"] for m in out["metrics"].values())
    assert value == pytest.approx(calls, rel=0.1)
    found = faults("throwaway.cell", bench, root)
    plant(monkeypatch, found[sorted(found)[0]])
    out = run.run_cell("throwaway.cell", SEED, 0.3, False, device="cpu",
                       bench=bench, root=root, overrides=small)
    assert out["correct"] is False
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run.run_cell(workload, SEED, 2.0, False)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"


def test_reference_bilinear_stays_in_range_in_bfloat16():
    """bfloat16 rounds 1919 up to 1920: the control must still index
    inside a 1920-wide plane."""
    plane = torch.arange(1920, dtype=torch.float32)[None, :].repeat(2, 1)
    u = torch.tensor([[0.9997, 1.0]], dtype=torch.bfloat16)
    out = ref_comp.bilinear(plane.to(torch.bfloat16), u,
                            torch.full_like(u, 0.5))
    assert out.shape == u.shape


def test_live_p99_per_layer_is_the_end_to_end_statistic():
    """The live cells read the frame latency's 99th percentile per layer,
    the wall end to end: both readers give the same number for one run,
    and none for a run that completed no frame."""
    here = cells.ROOT / "svbench"
    e2e = cells.load_module(here, "end_to_end", "frame_p99_ms")
    layer = cells.load_module(here, "layers", "compose.frame_p99_ms")
    fake = type("R", (), {})()
    fake.latencies = list(np.random.default_rng(SEED).random(500) / 100)
    assert layer.read(fake) == e2e.read(fake) == pytest.approx(
        np.percentile(fake.latencies, 99) * 1e3)
    fake.latencies = []
    assert layer.read(fake) is None and e2e.read(fake) is None
