"""CPU tests of the motion cells' own pieces: the kernels' bounds against
hand counts and a brute-force count, and the seeded pan the traffic
makes.  (Both cells also run through every test of the benchmark that is
parametrised over its cells: resolving, seeding, the tiny drive, the
control and the faults of ``faults/motion.py``.)

    python -m pytest svbench -q
"""

from __future__ import annotations

import json

import pytest
import torch

from svbench import cells
from svbench.bounds import motion as bounds
from svbench.bounds import peaks
from svbench.conftest import tiny

CONFIG = json.loads((cells.ROOT / "svbench/configs/motion1080.json")
                    .read_text())


def test_bounds_are_the_hand_counts_at_1080p():
    """The counts ``chip_smoke.py``'s motion rows print at 1080p, 16/64,
    refine 2: 4 692 377 600 pixel-candidate terms (K4: 0.07013 ms by its
    operations at 4 terms x 64 lanes x 132 SMs x 1980 MHz), 4 582 400
    stride-2 grid candidates (coarse: 0.001257 ms by its bytes) and
    8040 x 25 refine candidates (0.001267 ms by its bytes)."""
    frames = 2 * 1920 * 1080
    blocks = 67 * 120
    assert bounds.pixel_candidates(1080, 1920) == 4_692_377_600
    assert bounds.grid_candidates(1080, 1920) == (4_582_400, blocks * 25)
    assert bounds.sad_bound_s(CONFIG) == pytest.approx(
        4_692_377_600 / (4 * 64 * 132 * 1980e6))
    assert bounds.sad_bound_s(CONFIG) * 1e3 == pytest.approx(0.07013,
                                                             abs=5e-6)
    assert bounds.coarse_bound_s(CONFIG) == pytest.approx(
        (frames + blocks * 8) / peaks.HBM_BPS)
    assert bounds.coarse_bound_s(CONFIG) * 1e3 == pytest.approx(0.001257,
                                                                abs=5e-7)
    assert bounds.refine_bound_s(CONFIG) == pytest.approx(
        (frames + blocks * 12) / peaks.HBM_BPS)
    assert bounds.refine_bound_s(CONFIG) * 1e3 == pytest.approx(0.001267,
                                                                abs=5e-7)


def _brute(h, w, block, search, stride):
    """(pixel-candidate terms, grid candidates) block by block."""
    d_lo = block // 2 - search // 2
    terms = grid = 0
    for oy in range(0, h // block * block, block):
        ylo = min(max(oy + d_lo, 0), h)
        yhi = min(ylo + search, h) - block
        for ox in range(0, w // block * block, block):
            xlo = min(max(ox + d_lo, 0), w)
            xhi = min(xlo + search, w) - block
            for tx in range(xlo, xhi):
                for ty in range(ylo, yhi):
                    terms += block * block
                    grid += ((tx - ox - d_lo) % stride == 0
                             and (ty - ylo) % stride == 0)
    return terms, grid


@pytest.mark.parametrize("h,w,search", [(96, 128, 64), (88, 160, 64),
                                        (48, 64, 32), (96, 112, 62)])
def test_candidates_against_brute_force(h, w, search):
    stride = bounds.coarse_stride(w)
    terms, grid = _brute(h, w, 16, search, stride)
    assert bounds.pixel_candidates(h, w, 16, search) == terms
    assert bounds.grid_candidates(h, w, 16, search, stride)[0] == grid


def test_every_camera_pans_by_its_own_velocity():
    """Frame k + 1 of a camera's ring is frame k moved by one velocity
    within the pan, up to the noise: the luma differs by at most twice
    the noise where both crops overlap."""
    spec = cells.resolve(cells.load_benchmark(), "motion1080-pyramid",
                         overrides=tiny("motion1080-pyramid"))
    cell = spec.driver.Cell(spec.config, spec.traffic, 2**31 + 3,
                            torch.device("cpu"))
    pan, noise = spec.traffic["pan_px"], spec.traffic["noise_lsb"]
    for lumas in cell.luma:
        a, b = lumas[0].int(), lumas[1].int()
        h, w = a.shape
        fits = [(vx, vy) for vx in range(-pan, pan + 1)
                for vy in range(-pan, pan + 1)
                if (b[max(0, -vy):h - max(0, vy), max(0, -vx):w - max(0, vx)]
                    - a[max(0, vy):h - max(0, -vy),
                        max(0, vx):w - max(0, -vx)]).abs().max()
                <= 2 * noise]
        assert len(fits) == 1
        for k in range(1, len(lumas) - 1):
            vx, vy = fits[0]
            a, b = lumas[k].int(), lumas[k + 1].int()
            assert (b[max(0, -vy):h - max(0, vy), max(0, -vx):w - max(0, vx)]
                    - a[max(0, vy):h - max(0, -vy),
                        max(0, vx):w - max(0, -vx)]).abs().max() \
                <= 2 * noise
