"""The port's span and counter recorder (``core/spans.py``): off it records
nothing; on, spans nest with their parents and self time on each thread's
own stack, counters count, a tiny Composer gives the same frames and audio
either way and reaches every stage the CPU path has, and the benchmark's
readers of the records do their arithmetic right."""

import itertools
import sys
import threading

import numpy as np
import pytest
import torch

from swiftvideo_tpu_torch.core import (Bus, EventBox, StepClock, TimePoint,
                                       Tx, WallClock, spans)
from swiftvideo_tpu_torch.parallel.wall import MixingWall

from svbench import cells
from svbench.drivers import live

SEED = 2**31 + 5


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off."""
    spans.stop()
    yield
    spans.stop()


@pytest.fixture
def ticks(monkeypatch):
    """A clock that reads 0, 10, 20, ... ns, one step a reading."""
    counter = itertools.count(0, 10)
    monkeypatch.setattr(spans, "perf_counter_ns", lambda: next(counter))


def _graph(steps=3):
    """A clock, a bus fed before every step and an observer on it."""
    clock = StepClock(TimePoint(1, 100))
    bus = Bus(clock)
    seen = []
    keep = bus.subscribe(Tx(lambda v: (seen.append(v), EventBox.just(v))[1]))
    for k in range(steps):
        bus.append(EventBox.just(k))
        clock.step()
    return seen, keep


def test_off_records_nothing(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a site reached the recorder while it was off")

    monkeypatch.setattr(spans, "begin", refuse)
    monkeypatch.setattr(spans, "count", refuse)
    seen, _keep = _graph()
    assert seen == [0, 1, 2] and not spans.ON
    rec = spans.stop()
    assert len(rec) == 0 and rec.counters == {}


def test_nesting_parents_and_self_time(ticks):
    spans.start()
    a = spans.begin("outer")          # 0
    b = spans.begin("inner")          # 10
    spans.end(b)                      # 20
    c = spans.begin("inner")          # 30
    d = spans.begin("outer")          # 40: an outer inside an inner
    spans.end(d)                      # 50
    spans.end(c)                      # 60
    spans.end(a)                      # 70
    rec = spans.stop()
    names = [rec.names[k] for k in rec.name]
    assert names == ["outer", "inner", "inner", "outer"]
    assert rec.parent.tolist() == [-1, 0, 0, 2]
    assert (rec.end - rec.start).tolist() == [70, 10, 30, 10]
    # the nested outer is counted once in the total, and once in self time
    assert rec.total_ns("outer") == 70
    assert rec.total_ns("inner") == 40
    assert rec.total_ns("outer", inside="inner") == 0
    assert rec.total_ns("inner", inside="outer") == 40
    assert rec.self_ns("outer") == 70 - 40 + 10
    assert rec.self_ns("inner") == 40 - 10
    assert rec.self_ns("outer", "inner") == 70
    assert rec.count("inner") == 2 and rec.count("absent") == 0
    win = rec.window(10, 60)
    assert [win.names[k] for k in win.name] == ["inner", "inner", "outer"]
    assert win.parent.tolist() == [-1, -1, 1]
    assert win.timeline() == [(10, 20, "inner"), (30, 60, "inner"),
                              (40, 50, "outer")]


def test_a_span_left_open_hands_its_children_on(ticks):
    spans.start()
    a = spans.begin("outer")
    spans.begin("abandoned")          # an exception skipped its end
    b = spans.begin("inner")
    spans.end(b)
    spans.end(a)
    c = spans.begin("after")
    spans.end(c)
    rec = spans.stop()
    assert [rec.names[k] for k in rec.name] == ["outer", "inner", "after"]
    assert rec.parent.tolist() == [-1, 0, -1]


def test_step_ids_join_publishing_to_its_step():
    spans.start()
    _graph(steps=3)
    rec = spans.stop()
    names = [rec.names[k] for k in rec.name]
    # each step: the publishing's append, then the clock step
    assert names == ["bus.append", "clock.step"] * 3
    assert rec.step.tolist() == [0, 0, 1, 1, 2, 2]


def test_stacks_are_per_thread():
    clock = WallClock()
    done = threading.Event()
    bus = Bus(StepClock(TimePoint(1, 100)))
    keep = bus.subscribe(Tx(lambda v: EventBox.just(v)))

    def on_tick(_evt):
        bus.append(EventBox.just(1))

    spans.start()
    outer = spans.begin("main.outer")
    clock.schedule(clock.current(), on_tick)
    # runs after the first callback's step has ended
    clock.schedule(clock.current(), lambda _evt: done.set())
    assert done.wait(10)
    spans.end(outer)
    clock.close()
    rec = spans.stop()
    del keep
    names = [rec.names[k] for k in rec.name]
    main = rec.thread[names.index("main.outer")]
    step = names.index("clock.step")
    append = names.index("bus.append")
    assert rec.thread[step] == rec.thread[append] != main
    assert rec.parent[step] == -1 and rec.parent[append] == step


def test_threads_lose_no_span_step_or_count():
    """Eight threads, each opening spans, counting and ending clock steps,
    with the interpreter switching threads as often as it can."""
    threads, rounds = 8, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        spans.start()

        def work():
            for _ in range(rounds):
                outer = spans.begin("clock.step")
                spans.end(spans.begin("bus.append"))
                spans.count("n")
                spans.end_step(outer)

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(60)
        assert not any(t.is_alive() for t in pool)
        last = spans.begin("last")
        spans.end(last)
        rec = spans.stop()
    finally:
        sys.setswitchinterval(interval)
    assert len(rec) == 2 * threads * rounds + 1
    assert rec.counters == {"n": threads * rounds}
    assert rec.step[-1] == threads * rounds
    assert len(set(rec.thread.tolist())) == threads + 1
    inner = rec.parent[rec.name == rec.names.index("bus.append")]
    assert (rec.name[inner] == rec.names.index("clock.step")).all()


def test_counters_count_only_while_on():
    spans.count("x", 5)
    spans.start()
    spans.count("x", 2)
    spans.count("x")
    rec = spans.stop()
    spans.count("x", 7)
    assert rec.counters == {"x": 3}
    assert spans.stop().counters == {}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    yield
    torch.set_num_threads(threads)


def _tiny_station(traced: bool, steps: int):
    """The benchmark's live station at its tiny CPU size, hostcams traffic
    with a transition: every mixed frame's planes and audio frame's
    samples."""
    bench = cells.load_benchmark()
    spec = cells.resolve(bench, "live1080-transitions")
    small = live.tiny(spec.config, spec.traffic)
    config = dict(spec.config, **small["config"])
    traffic = dict(spec.traffic, **small["traffic"])
    cell = live.Cell(config, traffic, SEED, torch.device("cpu"))
    frames = []

    def on_frame(s):
        if s.asset_id() == "live":
            frames.append([p.clone() for p in s.planes()])
        return EventBox.just(s)

    keep = cell.picture_bus.subscribe(Tx(on_frame))
    if traced:
        spans.start()
    for _ in range(steps):
        cell.tick()
    rec = spans.stop() if traced else None
    cell.release()
    del keep
    return frames, [a for _v, _s, a in cell.audio_out], rec


# every span the CPU path of a station reaches (the uploads and the frame
# kernel's launches run only on the card)
STATION_SPANS = {
    "clock.step", "bus.append", "stage.repeater", "stage.picture_animator",
    "stage.sound_animator", "stage.src", "stats.timer", "stats.recompute",
    "stats.audio", "audio_mixer.tick", "audio_mixer.fold", "audio_mixer.emit",
    "video_mixer.tick", "video_mixer.uniforms", "video_mixer.emit"}


def test_tiny_station_same_output_traced_and_every_stage(one_thread):
    # 520 steps of 10 ms: past the stats reports' first 5 s summary
    plain_v, plain_a, _ = _tiny_station(False, 520)
    traced_v, traced_a, rec = _tiny_station(True, 520)
    assert len(plain_v) == len(traced_v) > 150
    assert all(torch.equal(a, b) for fa, fb in zip(plain_v, traced_v)
               for a, b in zip(fa, fb))
    assert len(plain_a) == len(traced_a) > 500
    assert all(np.array_equal(a, b) for a, b in zip(plain_a, traced_a))
    names = {rec.names[k] for k in set(rec.name.tolist())}
    assert names == STATION_SPANS
    assert rec.counters["video_mixer.uniform_lookups"] >= 5 * len(traced_v)
    assert 0 < rec.counters["video_mixer.uniform_misses"] \
        < rec.counters["video_mixer.uniform_lookups"]
    assert rec.step.max() == 519


def test_wall_spans_on_the_cpu():
    wall = MixingWall(n_streams=4, stream_size=(32, 18), canvas_size=(32, 16),
                      grid=(2, 2), audio_samples=8, channels=2, device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    ys = torch.randint(0, 256, (4, 18, 32), dtype=torch.uint8, generator=gen)
    us, vs = (torch.randint(0, 256, (4, 9, 16), dtype=torch.uint8,
                            generator=gen) for _ in range(2))
    au = torch.randint(-99, 99, (4, 16), dtype=torch.int16, generator=gen)
    plain = wall.step(ys, us, vs, au, uniforms=wall.default_uniforms())
    spans.start()
    traced = wall.step(ys, us, vs, au, uniforms=wall.default_uniforms())
    rec = spans.stop()
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
    assert [rec.names[k] for k in rec.name] == ["wall.step", "frame.cells",
                                                "wall.audio"]
    assert rec.parent.tolist() == [-1, 0, 0]


@pytest.mark.cuda
def test_spans_of_the_card_paths():
    """On the card: an upload's page-locked copy and enqueue inside its
    span, with its bytes counted, the cell wrapper's launch inside the
    wrapper's span and counted as the row kernel's, and the wall's audio mix
    counted as a kernel mix."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from swiftvideo_tpu_torch.ops import barriers
    card = torch.device("cuda", torch.cuda.current_device())
    planes = [np.full((36, 64), 7, np.uint8), np.full((18, 32), 9, np.uint8)]
    wall = MixingWall(n_streams=4, stream_size=(64, 36), canvas_size=(64, 32),
                      grid=(2, 2), audio_samples=8, channels=2, device=card)
    ys = torch.zeros((4, 36, 64), dtype=torch.uint8, device=card)
    us = vs = torch.zeros((4, 18, 32), dtype=torch.uint8, device=card)
    au = torch.zeros((4, 16), dtype=torch.int16, device=card)
    spans.start()
    up = [barriers.upload(p, card) for p in planes]
    wall.step(ys, us, vs, au)
    torch.cuda.synchronize()
    rec = spans.stop()
    assert all(np.array_equal(t.cpu().numpy(), p) for t, p in zip(up, planes))
    names = [rec.names[k] for k in rec.name]
    assert names == ["barriers.upload", "barriers.pin", "barriers.h2d"] * 2 \
        + ["wall.step", "frame.cells", "frame.launch", "wall.audio"]
    assert rec.parent.tolist() == [-1, 0, 0, -1, 3, 3, -1, 6, 7, 6]
    # the cell wrapper's plan lookup is counted too (a miss only where no
    # earlier call built this layout's plan)
    assert {k: v for k, v in rec.counters.items()
            if not k.startswith("frame.cell_plan_")} == {
        "barriers.uploads": 2, "barriers.upload_bytes": 64 * 36 + 32 * 18,
        "wall.audio_mixes": 1, "wall.audio_kernel_mixes": 1,
        "frame.cell_launches": 1, "frame.cell_row_launches": 1}
    assert rec.counters["frame.cell_plan_lookups"] == 1


# --- the benchmark's readers of the records --------------------------------

class _Trace:
    """A device trace holding ``copies`` host-to-device copies of
    ``seconds`` in all."""

    def __init__(self, copies, seconds):
        self.copies, self.seconds = copies, seconds

    def kernel(self, name):
        return (self.copies, self.seconds) if name == "Memcpy HtoD" \
            else (0, 0.0)


def _run(rec, frames, trace=None):
    run = type("Run", (), {})()
    run.program, run.frames, run.device_trace = rec, frames, trace
    return run


def _records(spans_, counters=None):
    """Records of (name, start, end, parent) rows, on one thread."""
    names = sorted({s[0] for s in spans_})
    cols = list(zip(*spans_))
    return spans.Records(
        names, np.array([names.index(n) for n in cols[0]], np.int32),
        np.array(cols[1], np.int64), np.array(cols[2], np.int64),
        np.array(cols[3], np.int64), np.zeros(len(spans_), np.int64),
        np.zeros(len(spans_), np.int64), counters or {})


def _reader(name):
    return cells.load_module(cells.ROOT / "svbench", "layers", name)


def test_readers_of_self_time():
    rec = _records([
        ("clock.step", 0, 1_000_000, -1),
        ("audio_mixer.tick", 100_000, 700_000, 0),
        ("stats.timer", 150_000, 160_000, 1),
        ("audio_mixer.emit", 400_000, 650_000, 1),
        ("bus.append", 420_000, 600_000, 3),
        ("stats.audio", 450_000, 500_000, 4),
        ("stage.src", 500_000, 520_000, 4),
        ("bus.append", 800_000, 900_000, 0)])
    run = _run(rec, frames=2)
    # clock.step 1 ms less the tick's 0.6 and the append's 0.1; the inner
    # append 0.18 less its 0.07 of children; the outer append 0.1
    assert _reader("core.self_ms").read(run) == pytest.approx(
        (0.3 + 0.11 + 0.1) / 2)
    assert _reader("stats.self_us").read(run) == pytest.approx((10 + 50) / 2)
    assert _reader("stages.self_us").read(run) == pytest.approx(20 / 2)
    assert _reader("audio_mixer.self_ms").read(run) == pytest.approx(
        (0.6 - 0.25) / 2)
    assert _reader("barriers.pin_ms").read(run) is None
    assert _reader("core.self_ms").read(_run(rec, frames=0)) is None


def test_readers_of_the_wall():
    rec = _records([
        ("wall.step", 0, 100_000, -1),
        ("frame.cells", 10_000, 70_000, 0),
        ("frame.launch", 20_000, 30_000, 1),
        ("frame.launch", 40_000, 55_000, 1),
        ("wall.audio", 75_000, 95_000, 0)])
    run = _run(rec, frames=1)
    assert _reader("wall.self_us").read(run) == pytest.approx(40)
    assert _reader("cells.self_us").read(run) == pytest.approx(35)
    assert _reader("cells.launch_us").read(run) == pytest.approx(25)
    # a wrapper that launched nothing (the CPU route) has nothing to read
    cpu = _run(_records([("wall.step", 0, 100_000, -1),
                         ("frame.cells", 10_000, 70_000, 0)]), frames=1)
    assert _reader("cells.self_us").read(cpu) is None
    assert _reader("cells.launch_us").read(cpu) is None


def test_readers_of_the_counters():
    rec = _records([("barriers.pin", 0, 10, -1)], counters={
        "barriers.uploads": 12, "barriers.upload_bytes": 12 * 3_110_400,
        "video_mixer.uniform_lookups": 400,
        "video_mixer.uniform_misses": 30})
    # 3.1104 MB a copy in 0.125 ms a copy: 24.8832 GB/s
    run = _run(rec, frames=1, trace=_Trace(80, 80 * 0.125e-3))
    assert _reader("barriers.h2d_gbps").read(run) == pytest.approx(24.8832)
    assert _reader("barriers.h2d_gbps").read(
        _run(rec, frames=1, trace=None)) is None
    assert _reader("video_mixer.uniform_miss_pct").read(run) == \
        pytest.approx(7.5)
    assert _reader("video_mixer.uniform_miss_pct").read(
        _run(_records([("x", 0, 1, -1)]), frames=1)) is None
    assert _reader("video_mixer.uniform_miss_pct").read(
        _run(None, frames=1)) is None


def test_reader_of_the_wall_audio_kernel_share():
    reader = _reader("wall.audio_kernel_pct")
    rec = _records([("wall.step", 0, 10, -1)], counters={
        "wall.audio_mixes": 40, "wall.audio_kernel_mixes": 30})
    assert reader.read(_run(rec, frames=1, trace=_Trace(0, 0.0))) == \
        pytest.approx(75.0)
    # a CPU run (no device trace) and a program that counts no mix
    assert reader.read(_run(rec, frames=1, trace=None)) is None
    assert reader.read(_run(_records([("wall.step", 0, 10, -1)]), frames=1,
                            trace=_Trace(0, 0.0))) is None
    assert reader.read(_run(None, frames=1, trace=_Trace(0, 0.0))) is None


# --- the motion search through the compute registry ------------------------

def _motion_search(device, name="me_fullsearch_pyramid", seed=SEED):
    """One registry search of a 64x48 pair on ``device``: the map."""
    from swiftvideo_tpu_torch.media import (BufferType, ImageBuffer,
                                            PictureSample, PixelFormat,
                                            create_picture_sample,
                                            planes_for_format)
    from swiftvideo_tpu_torch.ops import registry
    gen = torch.Generator().manual_seed(seed)
    samples = []
    for _ in range(2):
        planes = [torch.randint(0, 256, s, dtype=torch.uint8, generator=gen)
                  .to(device) for s in ((48, 64), (24, 32), (24, 32))]
        img = ImageBuffer(pixel_format=PixelFormat.y420p,
                          buffer_type=(BufferType.gpu
                                       if planes[0].is_cuda
                                       else BufferType.cpu),
                          size=(64, 48),
                          planes=tuple(planes_for_format(PixelFormat.y420p,
                                                         (64, 48))),
                          buffers=tuple(planes))
        samples.append(PictureSample(img, "cam", "w"))
    target = create_picture_sample((4, 3), PixelFormat.RGBA, asset_id="mv",
                                   workspace_id="w")
    return registry.run_compute_kernel(
        registry.make_compute_context(device), samples, target,
        registry.default_compute_kernel_from_string(name)).planes()[0]


@pytest.mark.parametrize("name", ["me_fullsearch_pyramid", "me_fullsearch"])
def test_motion_search_span_and_counter(name):
    """A registry search with the recorder on is one ``motion.search``
    span (no launch on the CPU: the plain versions) and counts one search;
    its map is the untraced one."""
    plain = _motion_search("cpu", name)
    spans.start()
    traced = _motion_search("cpu", name)
    rec = spans.stop()
    assert torch.equal(plain, traced)
    assert [rec.names[k] for k in rec.name] == ["motion.search"]
    assert rec.counters == {"motion.searches": 1}


def test_motion_search_off_records_nothing(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a site reached the recorder while it was off")

    monkeypatch.setattr(spans, "begin", refuse)
    monkeypatch.setattr(spans, "count", refuse)
    _motion_search("cpu")
    rec = spans.stop()
    assert len(rec) == 0 and rec.counters == {}


@pytest.mark.cuda
@pytest.mark.parametrize("name,launched", [
    ("me_fullsearch_pyramid", 2), ("me_fullsearch", 1)])
def test_motion_launches_inside_the_search_on_the_card(name, launched):
    """On the card each kernel launch is a ``motion.launch`` span inside
    the ``motion.search`` span, and the map is the untraced one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from swiftvideo_tpu_torch.ops import motion
    card = torch.device("cuda", torch.cuda.current_device())
    plain = _motion_search(card, name)
    torch.cuda.synchronize()
    before = motion.launches
    spans.start()
    traced = _motion_search(card, name)
    torch.cuda.synchronize()
    rec = spans.stop()
    assert torch.equal(plain, traced)
    assert motion.launches - before == launched
    names = [rec.names[k] for k in rec.name]
    assert names == ["motion.search"] + ["motion.launch"] * launched
    assert rec.parent.tolist() == [-1] + [0] * launched
    assert rec.counters == {"motion.searches": 1}


def test_readers_of_the_motion_search():
    rec = _records([
        ("motion.search", 0, 100_000, -1),
        ("motion.launch", 20_000, 30_000, 0),
        ("motion.launch", 40_000, 55_000, 0),
        ("motion.search", 200_000, 260_000, -1),
        ("motion.launch", 210_000, 215_000, 3),
        ("motion.launch", 220_000, 225_000, 3),
        ("motion.launch", 300_000, 310_000, -1)],
        counters={"motion.searches": 2})
    run = _run(rec, frames=2)
    # searches 160 us less their four launches' 35: 62.5 a search; the
    # launch outside any search is not counted
    assert _reader("motion.self_us").read(run) == pytest.approx(62.5)
    assert _reader("motion.launch_us").read(run) == pytest.approx(17.5)
    # the CPU route launches nothing: its own time, and no launch time
    cpu = _run(_records([("motion.search", 0, 40_000, -1)],
                        counters={"motion.searches": 1}), frames=1)
    assert _reader("motion.self_us").read(cpu) == pytest.approx(40)
    assert _reader("motion.launch_us").read(cpu) is None
    assert _reader("motion.self_us").read(_run(None, frames=1)) is None


# --- the rendition ladder ---------------------------------------------------

def _ladder_batch(device, n=3, size=(64, 36)):
    gen = torch.Generator().manual_seed(SEED)
    w, h = size
    return [torch.randint(0, 256, s, dtype=torch.uint8, generator=gen)
            .to(device) for s in ((n, h, w), (n, h // 2, w // 2),
                                  (n, h // 2, w // 2))]


def _ladder_plans(size=(64, 36), rungs=((32, 18), (48, 28))):
    from swiftvideo_tpu_torch.ops import matscale
    from swiftvideo_tpu_torch.ops.uniforms import identity_uniforms
    return [matscale.plan_scale(identity_uniforms(size, r), r, size[::-1])
            for r in rungs]


def test_ladder_span():
    """A ladder with the recorder on is one ``matscale.ladder`` span (the
    CPU's products make no cell call inside it) and counts nothing; its
    rungs are the untraced ones."""
    from swiftvideo_tpu_torch.ops import matscale
    batch, plans = _ladder_batch("cpu"), _ladder_plans()
    plain = matscale.scale_ladder(*batch, plans)
    spans.start()
    traced = matscale.scale_ladder(*batch, plans)
    rec = spans.stop()
    assert all(torch.equal(a, b) for p, q in zip(plain, traced)
               for a, b in zip(p, q))
    assert [rec.names[k] for k in rec.name] == ["matscale.ladder"]
    assert rec.counters == {}


def test_cell_plan_fast_lookups_are_counted(monkeypatch):
    """The cell wrapper's lookups that the last plan answers are counted as
    fast: a layout repeated, then two layouts taking turns (each lookup
    then misses the one kept plan and takes the full check)."""
    from swiftvideo_tpu_torch.media import PixelFormat
    from swiftvideo_tpu_torch.ops import frame
    monkeypatch.setattr(frame, "_recent", None)
    batch, plans = _ladder_batch("cpu"), _ladder_plans()
    unis = [np.broadcast_to(p.uniform, (3, 29)) for p in plans]

    def call(k):
        frame.composite_cells_cuda(plans[k].out_size, batch,
                                   PixelFormat.y420p, unis[k])
    spans.start()
    for k in (0, 0, 0):
        call(k)
    rec = spans.stop()
    assert rec.counters["frame.cell_plan_lookups"] == 3
    assert rec.counters["frame.cell_plan_fast"] == 2
    spans.start()
    for k in (1, 0, 1, 0):
        call(k)
    rec = spans.stop()
    assert rec.counters["frame.cell_plan_lookups"] == 4
    assert "frame.cell_plan_fast" not in rec.counters
    assert rec.counters.get("frame.cell_plan_misses", 0) <= 1


def test_ladder_off_records_nothing(monkeypatch):
    from swiftvideo_tpu_torch.media import PixelFormat
    from swiftvideo_tpu_torch.ops import frame, matscale

    def refuse(*_a, **_k):
        raise AssertionError("a site reached the recorder while it was off")

    monkeypatch.setattr(spans, "begin", refuse)
    monkeypatch.setattr(spans, "count", refuse)
    batch, plans = _ladder_batch("cpu"), _ladder_plans()
    matscale.scale_ladder(*batch, plans)
    for _ in range(2):
        frame.composite_cells_cuda(plans[0].out_size, batch,
                                   PixelFormat.y420p,
                                   np.broadcast_to(plans[0].uniform, (3, 29)))
    rec = spans.stop()
    assert len(rec) == 0 and rec.counters == {}


@pytest.mark.cuda
def test_ladder_cells_inside_the_ladder_on_the_card():
    """On the card the ladder is one ``frame.cells`` span with its one
    ``frame.launch`` inside the ``matscale.ladder`` span, one plan lookup
    that the kept plan (the untraced call's) answers, and the two rungs as
    one launch of the row kernel; the rungs are the untraced ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from swiftvideo_tpu_torch.ops import matscale
    card = torch.device("cuda", torch.cuda.current_device())
    batch, plans = _ladder_batch(card), _ladder_plans()
    plain = matscale.scale_ladder(*batch, plans)
    torch.cuda.synchronize()
    spans.start()
    traced = matscale.scale_ladder(*batch, plans)
    torch.cuda.synchronize()
    rec = spans.stop()
    assert all(torch.equal(a, b) for p, q in zip(plain, traced)
               for a, b in zip(p, q))
    names = [rec.names[k] for k in rec.name]
    assert names == ["matscale.ladder", "frame.cells", "frame.launch"]
    assert rec.parent.tolist() == [-1, 0, 1]
    assert not any(k.startswith("matscale.") for k in rec.counters)
    assert {k: rec.counters.get(k) for k in (
        "frame.cell_plan_lookups", "frame.cell_plan_fast",
        "frame.cell_launches", "frame.cell_row_launches")} == {
        "frame.cell_plan_lookups": 1, "frame.cell_plan_fast": 1,
        "frame.cell_launches": 1, "frame.cell_row_launches": 1}


class _KernelTrace:
    """A device trace holding ``launches`` frame-kernel launches of
    ``seconds`` in all."""

    def __init__(self, launches, seconds):
        self.launches, self.seconds = launches, seconds

    def kernel(self, name):
        return (self.launches, self.seconds) \
            if name == "frame_composite_kernel" else (0, 0.0)


def test_readers_of_the_ladder():
    """Two ticks of two channels, two rungs a tick."""
    rec = _records([
        ("matscale.ladder", 0, 100_000, -1),
        ("frame.cells", 10_000, 40_000, 0),
        ("frame.launch", 20_000, 30_000, 1),
        ("frame.cells", 50_000, 90_000, 0),
        ("frame.launch", 60_000, 75_000, 3),
        ("matscale.ladder", 200_000, 260_000, -1),
        ("frame.cells", 210_000, 230_000, 5),
        ("frame.launch", 215_000, 220_000, 6),
        ("frame.cells", 235_000, 255_000, 5),
        ("frame.launch", 240_000, 245_000, 8)], counters={
        "frame.cell_plan_lookups": 8, "frame.cell_plan_fast": 2,
        "frame.cell_launches": 8, "frame.cell_row_launches": 6})
    run = _run(rec, frames=4, trace=_KernelTrace(0, 0.0))
    run.config = {"channels": 2}
    # ladders 160 us less their cells' 110: 25 a tick; cells 110 less
    # their launches' 35: 37.5 a tick; launches 17.5 a tick
    assert _reader("ladder.self_us").read(run) == pytest.approx(25)
    assert _reader("ladder.cells_us").read(run) == pytest.approx(37.5)
    assert _reader("ladder.launch_us").read(run) == pytest.approx(17.5)
    assert _reader("ladder.plan_fast_pct").read(run) == pytest.approx(25)
    assert _reader("ladder.row_kernel_pct").read(run) == pytest.approx(75)
    # no fast lookup at all reads 0 where the program has the ladder's span
    none_fast = _records([("matscale.ladder", 0, 10, -1)],
                         counters={"frame.cell_plan_lookups": 5})
    assert _reader("ladder.plan_fast_pct").read(
        _run(none_fast, frames=2)) == 0
    # a program without the ladder's span: nothing to read
    older = _run(_records([("frame.cells", 0, 10, -1)], counters={
        "frame.cell_plan_lookups": 5}), frames=2)
    older.config = {"channels": 2}
    assert _reader("ladder.plan_fast_pct").read(older) is None
    assert _reader("ladder.self_us").read(older) is None
    assert _reader("ladder.launch_us").read(older) is None
    # a CPU run: no device trace, no launch share
    assert _reader("ladder.row_kernel_pct").read(
        _run(rec, frames=4, trace=None)) is None


def test_reader_of_the_ladder_roofline():
    """10 frame-kernel launches recorded in 1 ms, 50 launches over 10 ticks
    of 16 channels: 0.5 ms a tick against the configuration's bound."""
    from svbench.bounds import ladder, peaks
    config = {"channels": 16, "frame": {"size": [1920, 1080]},
              "rungs": [[1280, 720], [960, 540], [768, 432], [640, 360],
                        [416, 234]]}
    run = _run(None, frames=160, trace=_KernelTrace(10, 1e-3))
    run.config, run.counters = config, {"launches": 50}
    bound = ladder.bytes_per_tick(config) / peaks.HBM_BPS
    assert _reader("ladder_kernel.roofline_pct").read(run) == \
        pytest.approx(bound / 0.5e-3 * 100)
    assert bound == pytest.approx(29.879e-6, rel=1e-4)
    run.device_trace = None
    assert _reader("ladder_kernel.roofline_pct").read(run) is None


# --- the SRC stage and its resampler ---------------------------------------

def _src_feed(stage, sizes=(7, 1024, 441)):
    """Stereo f32p frames of ``sizes`` at 44.1 kHz through ``stage``: what
    it emitted."""
    from swiftvideo_tpu_torch.media.audio import AudioFormat, AudioSample
    rng = np.random.default_rng(SEED)
    out, at = [], 0
    for n in sizes:
        x = (0.25 * rng.standard_normal((2, n))).astype(np.float32)
        got = stage(AudioSample(
            buffers=tuple(x), frequency=44100, channels=2,
            format=AudioFormat.f32p, sample_count=n,
            pts_value=TimePoint(at, 44100), id_asset="mic",
            id_workspace="w")).value()
        if got is not None:
            out.append(got.data()[0])
        at += n
    return out


def _src_stage(route):
    from swiftvideo_tpu_torch.media.audio import AudioFormat
    from swiftvideo_tpu_torch.mix.src_audio import AudioSampleRateConversion
    kwargs = {"use_device": True, "device": "cpu"} if route == "device" \
        else {}
    return AudioSampleRateConversion(48000, 2, AudioFormat.s16i, **kwargs)


@pytest.mark.parametrize("route", ["device", "host"])
def test_src_spans_and_counters(route):
    """Frames of 7, 1024 and 441 samples: the first fills the filter and
    emits nothing (no product), then 1120 and 480 samples, 1600 of the
    1472 fed.  Each call is a ``resample.process`` span inside its
    ``stage.src``, the device route's product a ``resample.device`` span
    inside that; the output is the untraced one."""
    plain = _src_feed(_src_stage(route))
    spans.start()
    traced = _src_feed(_src_stage(route))
    rec = spans.stop()
    assert [len(a) for a in traced] == [2 * 1120, 2 * 480]
    assert all(np.array_equal(a, b) for a, b in zip(plain, traced))
    names = [rec.names[k] for k in rec.name]
    device = route == "device"
    call = ["stage.src", "resample.process"]
    assert names == call + (call + ["resample.device"] * device) * 2
    parents = [-1, 0] + ([-1, 2, 3, -1, 5, 6] if device
                         else [-1, 2, -1, 4])
    assert rec.parent.tolist() == parents
    assert rec.counters == {
        "resample.calls": 3, "resample.in_samples": 7 + 1024 + 441,
        "resample.out_samples": 1120 + 480,
        **({"resample.device_calls": 2} if device else {})}


def test_src_off_records_nothing(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a site reached the recorder while it was off")

    monkeypatch.setattr(spans, "begin", refuse)
    monkeypatch.setattr(spans, "count", refuse)
    assert len(_src_feed(_src_stage("device"))) == 2
    rec = spans.stop()
    assert len(rec) == 0 and rec.counters == {}


class _ResampleTrace:
    """A device trace whose window is 0-250 us on the host's clock (the
    profiler's clock 1000 ns ahead), holding a copy and two kernels of
    ``seconds`` in all."""

    host_offset_ns = 1000
    window_ns = (1000, 1000 + 250_000)

    def __init__(self, seconds):
        half = int(seconds * 1e9 / 2)
        self.events = [("Memcpy HtoD (Pageable -> Device)", 1000, 9000),
                       ("gemm", 2000, 2000 + half),
                       ("copy", 9000, 9000 + half)]


def test_readers_of_the_resampler():
    """Two frames, each a stage call around one resampler call with its
    device route, and a third device call outside the trace's window."""
    rec = _records([
        ("stage.src", 0, 100_000, -1),
        ("resample.process", 10_000, 90_000, 0),
        ("resample.device", 30_000, 80_000, 1),
        ("stage.src", 120_000, 200_000, -1),
        ("resample.process", 125_000, 195_000, 3),
        ("resample.device", 140_000, 190_000, 4),
        ("resample.device", 300_000, 310_000, -1)], counters={
        "resample.calls": 4, "resample.device_calls": 3,
        "resample.in_samples": 3 * 1024, "resample.out_samples": 3 * 1120})
    run = _run(rec, frames=2, trace=_ResampleTrace(4e-6))
    run.config = {"channels": 2, "taps_per_phase": 24}
    # stage calls 180 us less their resampler calls' 150: 15 a frame; the
    # resampler calls 150 less their device routes' 100: 25; device 50
    # (the one outside both stage calls counted too: (100 + 10) / 2)
    assert _reader("src.self_us").read(run) == pytest.approx(15)
    assert _reader("resample.self_us").read(run) == pytest.approx(25)
    assert _reader("resample.device_us").read(run) == pytest.approx(55)
    assert _reader("resample.device_route_pct").read(run) == \
        pytest.approx(75)
    # two device calls in the window, each bound by 2 x 4 x 2144 bytes at
    # 3.35 TB/s (5.12 ns; its 107 520 operations take 1.6 ns at 67
    # TFLOP/s), over the kernels' 4 us: the copy is not a kernel
    bound = 2 * 4 * (1024 + 1120) / 3.35e12
    assert _reader("resample_kernel.roofline_pct").read(run) == \
        pytest.approx(2 * bound / 4e-6 * 100)
    assert _reader("resample_kernel.roofline_pct").read(
        _run(rec, frames=2, trace=None)) is None
    # a program without the resampler's spans and counters (the stage's
    # span alone): nothing to read
    older = _run(_records([("stage.src", 0, 10, -1)]), frames=2,
                 trace=_ResampleTrace(4e-6))
    older.config = run.config
    for name in ("src.self_us", "resample.self_us", "resample.device_us",
                 "resample.device_route_pct",
                 "resample_kernel.roofline_pct"):
        assert _reader(name).read(older) is None, name
