"""CPU tests of the audio ingest cell's own pieces: the tiny drive end to
end through the stages' device route, every fault of
``faults/resample.py`` caught, the bound against the hand count for one
AAC frame, the reference against hand values of a 2-tap filter, and the
traffic's level and clipped frames.  (The cell also runs through every
test of the benchmark that is parametrised over its cells: resolving,
seeding, the tiny drive, the control and the faults.)

    python -m pytest svbench -q
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from svbench import cells, run
from svbench.bounds import peaks, resample as bounds
from svbench.conftest import faults, plant, tiny
from svbench.reference import resample as ref

WORKLOAD = "resample128-aac"
CONFIG = json.loads((cells.ROOT / "svbench/configs/resample128.json")
                    .read_text())
TRAFFIC = json.loads((cells.ROOT / "svbench/traffic/aac.json").read_text())
SEED = 2**31 + 13


def _cell(seed=SEED, overrides=None):
    spec = cells.resolve(cells.load_benchmark(), WORKLOAD,
                         overrides=overrides or tiny(WORKLOAD))
    return spec, spec.driver.Cell(spec.config, spec.traffic, seed,
                                  torch.device("cpu"))


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_drive_passes_on_the_device_route(trace, monkeypatch):
    """Every conversion of the tiny drive goes through a stage's resampler
    on the device route (torch on the CPU here), and the run is correct."""
    from swiftvideo_tpu_torch.ops import resample
    routes = set()
    process = resample.PolyphaseResampler.process

    def spy(self, x):
        routes.add((self.use_device, str(self.device)))
        return process(self, x)
    monkeypatch.setattr(resample.PolyphaseResampler, "process", spy)
    out = run.run_cell(WORKLOAD, SEED, 0.3, bool(trace), device="cpu",
                       overrides=tiny(WORKLOAD))
    assert out["correct"] is True, out["checks"]
    assert routes == {(True, "cpu")}
    assert out["attempted"] > 0 and out["failed"] == 0
    if trace:
        got = {k: v["value"] for k, v in out["metrics"].items()}
        assert set(got) == {"src.self_us", "resample.self_us",
                            "resample.device_us",
                            "resample.device_route_pct"}
        # the tiny frames of 7 samples fill the filter without a product
        assert 0 < got["resample.device_route_pct"] < 100


@pytest.mark.parametrize("fault", sorted(faults(WORKLOAD)))
def test_fault_is_caught(fault, monkeypatch):
    plant(monkeypatch, faults(WORKLOAD)[fault])
    out = run.run_cell(WORKLOAD, SEED, 0.3, False, device="cpu",
                       overrides=tiny(WORKLOAD))
    assert out["correct"] is False, out["checks"]


def test_bound_is_the_hand_count_for_one_aac_frame():
    """A stereo 1024-sample frame that emits 1120 samples: 2 x 4 x (1024 +
    1120) = 17 152 bytes, 5.120 ns at 3.35 TB/s, against 2 x 24 x 2 x 1120
    = 107 520 operations, 1.605 ns at 67 TFLOP/s: bound by its bytes.  One
    that emits 960: 15 872 bytes, 4.738 ns."""
    assert CONFIG["taps_per_phase"] == 24 and CONFIG["channels"] == 2
    assert bounds.bytes_per_call(2, 1024, 1120) == 17_152
    assert bounds.flops_per_call(2, 1120, 24) == 107_520
    assert bounds.seconds_per_call(2, 1024, 1120, 24) == pytest.approx(
        17_152 / peaks.HBM_BPS) == pytest.approx(5.120e-9, abs=1e-12)
    assert 107_520 / bounds.FP32_FLOPS == pytest.approx(1.605e-9, abs=1e-12)
    assert bounds.seconds_per_call(2, 1024, 960, 24) == pytest.approx(
        4.738e-9, abs=1e-12)


def test_reference_hand_values_of_a_two_tap_filter():
    """L = 2, M = 1, two taps a phase: phase 0 weights x[n / 2] by 0.75
    and the sample before it by 0.25, phase 1 both by 0.5; before the
    stream and past the input are zeros."""
    d = ref.Design(np.array([[0.75, 0.25], [0.5, 0.5]], np.float32),
                   L=2, M=1, K=2, r_lo=-1, r_hi=0)
    x = torch.tensor([[4.0, 8.0, -4.0, 0.0]])
    y = ref.outputs(d, x, 0, 9)
    assert y.tolist() == [[3.0, 2.0, 7.0, 6.0, -1.0, 2.0, -1.0, -2.0, 0.0]]
    # a later block from the inputs it needs alone, x[1] to x[3]
    assert ref.inputs_needed(d, 4, 8) == (1, 4)
    assert ref.outputs(d, x[:, 1:4], 4, 8, first=1).tolist() == \
        [[-1.0, 2.0, -1.0, -2.0]]
    # every input sample emits two outputs (a cycle needs x[c]); a flush
    # feeds r_hi - r_lo + 1 = 2 zeros
    assert [ref.emitted(d, n) for n in range(4)] == [0, 2, 4, 6]
    assert ref.flush_samples(d) == 2
    assert ref.first_pts(441, 44100, 48000) == 480
    assert ref.first_pts(1, 44100, 48000) == 1
    assert ref.first_pts(-1, 44100, 48000) == -1
    assert ref.first_pts(7, 48000, 48000) == 7
    # s16: round half to even, clipped, channels interleaved
    q = ref.to_s16(torch.tensor([[1.5, 2.5, 4e4], [-1.5, -0.5, -4e4]])
                   / 32768)
    assert q.tolist() == [2, -2, 2, 0, 32767, -32768]


def test_reference_design_of_a_two_tap_filter():
    """The published design at L = 2, K = 2: a symmetric prototype, so
    each phase's unit-gain taps are (a, 1 - a) and (1 - a, a), and an
    impulse comes out as a, 1 - a, 1 - a, a."""
    d = ref.design(1, 2, taps_per_phase=2)
    assert (d.L, d.M, d.K, d.r_lo, d.r_hi) == (2, 1, 2, -1, 0)
    a = float(d.taps[0, 0])
    assert 0 < a < 0.5
    np.testing.assert_allclose(d.taps, [[a, 1 - a], [1 - a, a]], atol=1e-7)
    y = ref.outputs(d, torch.tensor([[1.0, 0.0, 0.0]]), 0, 6)
    np.testing.assert_allclose(y[0], [a, 1 - a, 1 - a, a, 0, 0], atol=1e-7)


def test_traffic_level_and_clipped_frames():
    """Two streams over the cell's whole ring: the signal near -18 dBFS and
    about 1 % of the frames past full scale."""
    _spec, cell = _cell(overrides={"config": {"streams": 2}})
    ring = cell.ring
    assert ring.shape == (2, 2, TRAFFIC["ring_frames"] * 1024)
    rms = float(np.sqrt(np.mean(ring.astype(np.float64) ** 2)))
    assert 20 * np.log10(rms) == pytest.approx(-18, abs=1.5)
    frames = ring.reshape(2, 2, TRAFFIC["ring_frames"], 1024)
    clipped = (np.abs(frames) > 1).any(axis=(1, 3)).mean()
    assert 0 < clipped < 0.05
