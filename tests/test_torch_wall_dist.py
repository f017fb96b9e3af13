"""The port's mixing wall split over 4 ``torch.distributed`` ranks (gloo,
on the CPU) against the one-device port wall on the same inputs: every
rank's output must be bit-equal to its part of the one-device wall (its
band of wall rows on aligned layouts, the whole wall on the gather
layout), video and audio.  Layouts follow ``dryrun_multichip``
(__graft_entry__.py) at 4 devices: 16 streams square aligned, 24 streams as
6x4 rectangular aligned, 10 streams padded to 12 through the tile gather;
and per-cell uniforms on the square and the gather layout.  The ranks
start once per module (``torch.multiprocessing.spawn``) and meet through a
``file://`` store under the test's temporary directory, so parallel test
workers never share a port.  Audio gains are powers of two: every float32
partial sum is exact, so the all_reduce order cannot move a bit."""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from swiftvideo_tpu_torch.ops.uniforms import identity_uniforms, rect_uniforms
from swiftvideo_tpu_torch.parallel import MixingWall

WORLD = 4
STREAM = (32, 18)
SAMPLES = 48


def _auto_canvas(n):
    gw = int(np.ceil(np.sqrt(n)))
    return (gw * 16, int(np.ceil(n / gw)) * 8)


# name -> (streams, grid, canvas, per-cell uniforms, aligned over 4 ranks)
CASES = {
    "square": (WORLD * WORLD, (WORLD, WORLD), (WORLD * 16, WORLD * 8), False,
               True),
    "rect 6x4": (6 * WORLD, (6, WORLD), (96, WORLD * 8), False, True),
    "gather": (2 * WORLD + WORLD // 2, None, _auto_canvas(2 * WORLD + 2),
               False, False),
    "square per-cell": (WORLD * WORLD, (WORLD, WORLD),
                        (WORLD * 16, WORLD * 8), True, True),
    "gather per-cell": (2 * WORLD + 2, None, _auto_canvas(2 * WORLD + 2),
                        True, False),
}


def _inputs(name):
    n, grid, canvas, per_cell, _aligned = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    sw, sh = STREAM
    ys = rng.integers(0, 256, (n, sh, sw), np.int64).astype(np.uint8)
    us = rng.integers(0, 256, (n, sh // 2, sw // 2), np.int64).astype(np.uint8)
    vs = rng.integers(0, 256, (n, sh // 2, sw // 2), np.int64).astype(np.uint8)
    audio = rng.integers(-30000, 30000, (n, SAMPLES * 2),
                         np.int64).astype(np.int16)
    gains = rng.choice(np.float32([0.5, 1.0, 2.0]), n)
    unis = None
    if per_cell:
        gw = grid[0] if grid else int(np.ceil(np.sqrt(n)))
        gh = grid[1] if grid else int(np.ceil(n / gw))
        tile = (canvas[0] // gw, canvas[1] // gh)
        unis = np.stack([identity_uniforms(STREAM, tile).pack()] * n)
        unis[0] = identity_uniforms(STREAM, tile, opacity=0.5).pack()
        unis[n - 1] = rect_uniforms(
            STREAM, tile, x=1.25, y=0.75, w=tile[0] - 2.5, h=tile[1] - 1.5,
            fill_color=(0.2, 0.7, 0.4, 0.5)).pack()
    return n, grid, canvas, (ys, us, vs, audio, gains), unis


def _run(wall, inputs, unis):
    planes = [wall.shard(a) for a in inputs]
    return [o.clone() for o in wall.step(
        *planes, uniforms=None if unis is None else wall.shard(unis))]


def _rank_main(rank, store, out):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    try:
        results = {}
        for name in CASES:
            n, grid, canvas, inputs, unis = _inputs(name)
            wall = MixingWall(n_streams=n, stream_size=STREAM,
                              canvas_size=canvas, grid=grid,
                              audio_samples=SAMPLES, device="cpu",
                              group=dist.group.WORLD)
            results[name] = (wall.aligned, wall.local, _run(wall, inputs,
                                                            unis))
        torch.save(results, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's (aligned, local streams, outputs) per case."""
    tmp = tmp_path_factory.mktemp("gloo_wall")
    mp.spawn(_rank_main, args=(str(tmp / "store"), str(tmp)), nprocs=WORLD,
             join=True)
    return [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_bit_equal_one_device_wall(ranks, name):
    n, grid, canvas, inputs, unis = _inputs(name)
    one = MixingWall(n_streams=n, stream_size=STREAM, canvas_size=canvas,
                     grid=grid, audio_samples=SAMPLES, device="cpu")
    want = _run(one, inputs, unis)
    aligned = CASES[name][4]
    th = one.tile[1]
    for rank, results in enumerate(ranks):
        got_aligned, local, got = results[name]
        assert got_aligned == aligned
        assert local == -(-n // WORLD)
        if aligned:
            rows = local // one.grid_wh[0]
            band = slice(rank * rows * th, (rank + 1) * rows * th)
            cband = slice(rank * rows * th // 2, (rank + 1) * rows * th // 2)
            expect = [want[0][band], want[1][cband], want[2][cband]]
        else:
            expect = want[:3]
        for g, e in zip(got[:3], expect):
            assert g.dtype == torch.uint8 and torch.equal(g, e)
        assert got[3].dtype == torch.int16 and torch.equal(got[3], want[3])
