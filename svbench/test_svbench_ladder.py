"""CPU tests of the ladder cell's own pieces: the tick's byte bound against
the hand count, the tiny drive's check at 0 LSB through the plain per-cell
fold, the faults of ``faults/ladder.py`` caught, and the seeded pan of the
traffic.  (The cell also runs through every test of the benchmark that is
parametrised over its cells: resolving, seeding, the tiny drive, the
control and the faults.)

    python -m pytest svbench -q
"""

from __future__ import annotations

import json

import pytest
import torch

from svbench import cells, run
from svbench.bounds import cell_kernel, ladder as bounds, peaks
from svbench.conftest import faults, plant, tiny

WORKLOAD = "ladder1080-hls"
CONFIG = json.loads((cells.ROOT / "svbench/configs/ladder1080.json")
                    .read_text())
SEED = 2**31 + 5


def test_bound_is_the_hand_count_at_the_published_rungs():
    """16 channels, each 1080p frame read once as the union of its five
    rungs' tap sectors (3 106 560 bytes: 1280x720 and 960x540 alone tap
    every row of each plane but its last, which no tap weights, and every
    column) and the rungs written (3 149 280 bytes): 100.09 MB a tick,
    29.88 us at 3.35 TB/s.  Each rung alone reads what
    ``cell_kernel.stream_bytes`` counts for it."""
    rungs = [(1280, 720), (960, 540), (768, 432), (640, 360), (416, 234)]
    assert [tuple(r) for r in CONFIG["rungs"]] == rungs
    all_but_last = 1079 * 1920 + 2 * 539 * 960
    taps = [cell_kernel.stream_bytes((1920, 1080), r) for r in rungs]
    assert taps[0] == taps[1] == all_but_last
    assert [bounds.read_bytes((1920, 1080), [r]) for r in rungs] == taps
    assert bounds.read_bytes((1920, 1080), rungs) == all_but_last \
        == 3_106_560
    written = sum(w * h + 2 * (w // 2) * (h // 2) for w, h in rungs)
    assert written == 3_149_280
    assert bounds.bytes_per_tick(CONFIG) == 16 * (3_106_560 + 3_149_280) \
        == 100_093_440
    assert bounds.bytes_per_tick(CONFIG) / peaks.HBM_BPS * 1e6 == \
        pytest.approx(29.879, abs=1e-3)


def test_bound_reads_a_byte_two_rungs_tap_once():
    """Two rungs of one size need the frame's taps once; rungs whose taps
    miss each other's sectors add up."""
    size = (64, 36)
    one = bounds.read_bytes(size, [(32, 18)])
    assert bounds.read_bytes(size, [(32, 18), (32, 18)]) == one
    both = bounds.read_bytes(size, [(32, 18), (48, 28)])
    assert max(one, bounds.read_bytes(size, [(48, 28)])) <= both \
        <= one + bounds.read_bytes(size, [(48, 28)])


def _cell(seed=SEED):
    spec = cells.resolve(cells.load_benchmark(), WORKLOAD,
                         overrides=tiny(WORKLOAD))
    return spec, spec.driver.Cell(spec.config, spec.traffic, seed,
                                  torch.device("cpu"))


def test_tiny_drive_takes_the_plain_fold_and_passes(monkeypatch):
    """On the CPU every rung is one call of the cell wrapper with the plan's
    uniforms (the plain per-cell fold), never the products, and the check
    reads 0 LSB over every channel and rung."""
    from swiftvideo_tpu_torch.ops import frame, matscale
    spec, cell = _cell()
    seen = []
    wrapper = frame.composite_cells_cuda

    def cells_call(cell_size, planes, fmt, uniforms, **kwargs):
        seen.append((tuple(cell_size), uniforms))
        return wrapper(cell_size, planes, fmt, uniforms, **kwargs)
    monkeypatch.setattr(frame, "composite_cells_cuda", cells_call)
    products = matscale.calls
    cell.warm()
    cell.tick()
    rungs = [tuple(r) for r in spec.config["rungs"]]
    ticks = spec.traffic["warm_ticks"] + 1
    assert [s for s, _u in seen] == rungs * ticks
    for (_s, unis), plan in zip(seen, cell.plans * ticks):
        assert unis.shape == (cell.n, 29) and (unis == plan.uniform).all()
    assert matscale.calls == products
    assert cell.check(torch.float32) == {"video_max_lsb": (0, 0)}


@pytest.mark.parametrize("fault", sorted(faults(WORKLOAD)))
def test_fault_is_caught(fault, monkeypatch):
    plant(monkeypatch, faults(WORKLOAD)[fault])
    out = run.run_cell(WORKLOAD, SEED, 0.3, False, device="cpu",
                       overrides=tiny(WORKLOAD))
    assert out["correct"] is False
    assert out["checks"]["video_max_lsb"]["value"] > 0


def test_every_channel_pans_by_its_own_velocity():
    """Batch k + 1 holds each channel's frame k moved by one velocity
    within the pan, up to the noise, and the channels differ."""
    spec, cell = _cell(SEED + 1)
    pan, noise = spec.traffic["pan_px"], spec.traffic["noise_lsb"]
    (y0, _u0, _v0), (y1, _u1, _v1) = cell.ring[:2]
    assert not torch.equal(y0[0], y0[1])
    for a, b in zip(y0.int(), y1.int()):
        h, w = a.shape
        fits = [(vx, vy) for vx in range(-pan, pan + 1)
                for vy in range(-pan, pan + 1)
                if (b[max(0, -vy):h - max(0, vy), max(0, -vx):w - max(0, vx)]
                    - a[max(0, vy):h - max(0, -vy),
                        max(0, vx):w - max(0, -vx)]).abs().max()
                <= 2 * noise]
        assert len(fits) == 1
