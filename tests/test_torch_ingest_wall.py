"""RTMP ingest at a station's size on the port, on the CPU.

* Twin of ``tests/test_wall.py::test_wall_fed_by_64_rtmp_ingest_sessions``:
  64 concurrent publishers into one port ``Rtmp`` server; each session's
  latest sample seeds its stream, and the port's ``MixingWall`` (plan path
  and per-cell path) is held within 1 LSB of the JAX wall on the same
  streams, each tile traced back to the session that made it.
* Twins of the two RTMP soak tests of ``tests/test_soak.py``
  (``test_soak_rtmp_loopback_sustained``,
  ``test_soak_concurrent_rtmp_ingest_16_publishers``) at reduced frame
  counts (500 of 2000 frames; 40 of 120 frames a publisher), so that the
  file stays a few seconds long.
"""

import asyncio
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftvideo_tpu.parallel import MixingWall as JaxWall, make_mesh
from swiftvideo_tpu_torch.core import EventBox, StepClock, TimePoint, Tx
from swiftvideo_tpu_torch.media.coded import (CodedMediaSample, MediaFormat,
                                              MediaType)
from swiftvideo_tpu_torch.net.rtmp import Rtmp
from swiftvideo_tpu_torch.ops import frame
from swiftvideo_tpu_torch.parallel import MixingWall


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch ops here are many and small: one intra-op thread, so that an
    xdist worker sharing its cores with five others waits on no OpenMP
    barrier (with a thread per core a small op can wait a scheduler slice)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _avc(buf, ts, asset):
    return CodedMediaSample(
        buffer=buf, pts_value=ts, dts_value=ts, media_type=MediaType.video,
        media_format=MediaFormat.avc, id_asset=asset, id_workspace="w",
        side={"config": bytes(48)})


async def _ingest(n, port):
    """n publishers, 3 samples each (200 bytes, 0x65, seed 3k+2 at byte
    5); returns each session's latest sample by play path."""
    clock = StepClock(TimePoint(16, 1000))
    latest, keep = {}, []

    async def on_connection(pub, sub):
        if sub is not None:
            name = sub.play_path()
            keep.append(sub >> Tx(
                lambda s, name=name: (latest.__setitem__(name, s),
                                      EventBox.nothing(None))[1]))
        return True

    server = Rtmp(clock, on_connection=on_connection)
    await server.serve("127.0.0.1", port)
    pubs = []
    for k in range(n):
        pub, _ = await Rtmp(clock).connect(
            f"rtmp://127.0.0.1:{port}/wall/cam{k}", publish_to_peer=True,
            max_attempts=3, retry_delay=0.2)
        pubs.append(pub)
    for _ in range(14):
        clock.step()
        await asyncio.sleep(0)
    ts = TimePoint(0, 1000)
    for _ in range(3):
        for k, pub in enumerate(pubs):
            body = bytearray(200)
            body[4] = 0x65
            body[5] = 3 * k + 2
            pub.apply(EventBox.just(_avc(bytes(body), ts, f"cam{k}")))
        ts = ts + TimePoint(16, 1000)
        clock.step()
        await asyncio.sleep(0)
    deadline = asyncio.get_event_loop().time() + 20.0
    while len(latest) < n and asyncio.get_event_loop().time() < deadline:
        await asyncio.sleep(0)
    for pub in pubs:
        pub.close()
    await server.close()
    return latest


def test_wall_fed_by_64_rtmp_ingest_sessions():
    n, sw, sh = 64, 32, 16
    latest = asyncio.run(_ingest(n, _free_port()))
    assert len(latest) == n
    seeds = np.array([latest[f"cam{k}"].data()[5] for k in range(n)],
                     np.uint8)
    assert sorted(seeds.tolist()) == [3 * k + 2 for k in range(n)]
    # each stream's luma is its seed plus a ramp, so that the sampling is
    # exercised; chroma is flat grey; audio a constant
    ramp = (np.arange(sw)[None, :] // 4).astype(np.uint8)
    ys = np.broadcast_to(seeds[:, None, None] + ramp[None],
                         (n, sh, sw)).astype(np.uint8)
    us = np.full((n, sh // 2, sw // 2), 128, np.uint8)
    vs = us.copy()
    audio = np.full((n, 16 * 2), 10, np.int16)

    jwall = JaxWall(make_mesh(jax.devices()[:8]), n_streams=n,
                    stream_size=(sw, sh), canvas_size=(128, 64),
                    audio_samples=16, channels=2)
    theirs = [np.asarray(o) for o in jwall.step(
        *(jwall.shard(jnp.asarray(a)) for a in (ys, us, vs, audio)))]
    wall = MixingWall(n_streams=n, stream_size=(sw, sh),
                      canvas_size=(128, 64), audio_samples=16, channels=2,
                      device="cpu")
    plan = [o.numpy() for o in wall.step(
        *(wall.shard(a) for a in (ys, us, vs, audio)))]
    launches = frame.launches
    cells = [o.numpy() for o in wall.step(
        *(wall.shard(a) for a in (ys, us, vs, audio)),
        uniforms=wall.default_uniforms())]
    assert frame.launches == launches        # CPU tensors: plain versions
    for ours in (plan, cells):
        for a, b in zip(ours[:3], theirs[:3]):
            assert a.shape == b.shape
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        assert np.all(ours[3] == 10 * n) and np.array_equal(ours[3],
                                                            theirs[3])
    # an 8x8 grid of 16x8 tiles: every tile shows its session's seed
    for k in range(n):
        r, c = divmod(k, 8)
        assert abs(int(cells[0][r * 8 + 4, c * 16]) - int(seeds[k])) <= 1


async def _sustained(port, n):
    clock = StepClock(TimePoint(16, 1000))
    received, keep = [], {}

    async def on_connection(pub, sub):
        if sub is not None:
            keep["chain"] = sub >> Tx(
                lambda s: (received.append(s), EventBox.nothing(None))[1])
        return True

    server = Rtmp(clock, on_connection=on_connection)
    await server.serve("127.0.0.1", port)
    pub, _ = await Rtmp(clock).connect(
        f"rtmp://127.0.0.1:{port}/soak/stream", publish_to_peer=True,
        max_attempts=3, retry_delay=0.2)
    data = bytearray(np.random.default_rng(3).integers(0, 256, 7993)
                     .astype(np.uint8).tobytes())
    data[4] = 0x65
    for _ in range(14):
        clock.step()
        await asyncio.sleep(0)
    ts = TimePoint(0, 1000)
    for i in range(n):
        pub.apply(EventBox.just(_avc(bytes(data), ts, "soak")))
        ts = ts + TimePoint(16, 1000)
        clock.step()
        if i % 16 == 0:
            await asyncio.sleep(0)
    deadline = asyncio.get_event_loop().time() + 20.0
    while len(received) < n and asyncio.get_event_loop().time() < deadline:
        await asyncio.sleep(0)
    for state in server._sessions.values():
        assert state["core"].deserializer.pending < 1 << 20
        assert not state["core"].fatal
    pub.close()
    await server.close()
    return received


def test_soak_rtmp_loopback_sustained():
    """500 frames (the JAX twin sends 2000) through real sockets without
    loss, and the session cores keep no unbounded buffers."""
    n = 500
    received = asyncio.run(_sustained(_free_port(), n))
    assert len(received) == n
    assert received[-1].pts().value == (n - 1) * 16
    assert received[-1].data() == received[0].data()


@pytest.mark.parametrize("native", ["1", "0"], ids=["native", "python"])
def test_soak_concurrent_rtmp_ingest_16_publishers(native, monkeypatch):
    """16 publishers into one server (the JAX twin sends 120 frames each,
    this one 40), on both dechunker routes: every session delivers every
    frame in pts order with its own payload, and every core stays
    healthy."""
    from swiftvideo_tpu_torch.net.rtmp import chunks

    if native == "1" and not chunks.native_available():
        pytest.skip("libsvrtmp.so not available")
    monkeypatch.setattr(chunks, "_lib", chunks._lib if native == "1"
                        else None)
    n_pub, n_frames = 16, 40
    port = _free_port()
    base = np.random.default_rng(9).integers(0, 256, 4093).astype(
        np.uint8).tobytes()

    def payload(k, i):
        head = bytearray(base[:16])
        head[4] = 0x65
        head[5], head[6] = k, i % 251
        return bytes(head) + base[16:]

    async def run():
        clock = StepClock(TimePoint(16, 1000))
        received, keep = {}, []

        async def on_connection(pub, sub):
            if sub is not None:
                lst = received.setdefault(sub.play_path(), [])
                keep.append(sub >> Tx(
                    lambda s, lst=lst: (lst.append(s),
                                        EventBox.nothing(None))[1]))
            return True

        server = Rtmp(clock, on_connection=on_connection)
        await server.serve("127.0.0.1", port)
        pubs = []
        for k in range(n_pub):
            pub, _ = await Rtmp(clock).connect(
                f"rtmp://127.0.0.1:{port}/soak/cam{k}",
                publish_to_peer=True, max_attempts=3, retry_delay=0.2)
            pubs.append(pub)
        for _ in range(14):
            clock.step()
            await asyncio.sleep(0)
        ts = TimePoint(0, 1000)
        for i in range(n_frames):
            for k, pub in enumerate(pubs):
                pub.apply(EventBox.just(_avc(payload(k, i), ts, f"cam{k}")))
            ts = ts + TimePoint(16, 1000)
            clock.step()
            await asyncio.sleep(0)
        deadline = asyncio.get_event_loop().time() + 30.0
        while (sum(len(v) for v in received.values()) < n_pub * n_frames
               and asyncio.get_event_loop().time() < deadline):
            await asyncio.sleep(0)
        for state in server._sessions.values():
            core = state["core"]
            assert core.deserializer.native == (native == "1")
            assert core.deserializer.pending < 1 << 20
            assert not core.fatal
        for pub in pubs:
            pub.close()
        await server.close()
        return received

    received = asyncio.run(run())
    assert len(received) == n_pub
    for k in range(n_pub):
        frames = received[f"cam{k}"]
        assert len(frames) == n_frames, f"cam{k}: {len(frames)}"
        for i, f in enumerate(frames):
            assert f.pts().value == i * 16
            assert f.data()[5] == k and f.data()[6] == i % 251
