"""Twin of ``tests/test_ingest_sharding.py`` on the port (``swiftvideo_tpu_torch``).

SO_REUSEPORT ingest sharding: N worker processes serve ONE port and
the kernel spreads publisher connections across them.

This is the scale-out shape for the GIL-bound ingest ceiling (one
asyncio loop runs on one core): the reference
gets multi-core ingest for free from SwiftNIO's threaded EventLoopGroup
(net.tcp.swift:147-156); the asyncio port gets it from socket sharding,
one process per core.  This test proves CORRECTNESS of the sharded shape
(every published frame lands on exactly one worker, none lost, sessions
fully isolated per worker) — it makes no single-core throughput claim.
"""
import multiprocessing as mp
import os
import socket
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _worker(port: int, qin, qout) -> None:
    """One ingest worker: serve the shared port, count video frames per
    publisher path, answer 'report' with (pid, {path: n})."""
    sys.path.insert(0, REPO)
    import asyncio

    from swiftvideo_tpu_torch.core import EventBox, StepClock, TimePoint, Tx
    from swiftvideo_tpu_torch.net.rtmp import Rtmp

    async def run() -> None:
        clock = StepClock(TimePoint(16, 1000))
        counts: dict = {}
        keep = []

        async def on_connection(pub, sub):
            if sub is not None:
                path = sub.play_path()
                counts.setdefault(path, 0)

                def bump(s, path=path):
                    counts[path] += 1
                    return EventBox.nothing(None)

                keep.append(sub >> Tx(bump))
            return True

        server = Rtmp(clock, on_connection=on_connection)
        await server.serve("127.0.0.1", port, reuse_port=True)
        qout.put(("ready", os.getpid(), None))
        loop = asyncio.get_running_loop()
        while True:
            msg = await loop.run_in_executor(None, qin.get)
            if msg == "report":
                qout.put(("counts", os.getpid(), dict(counts)))
            elif msg == "stop":
                break
        await server.close()

    asyncio.run(run())


@pytest.mark.skipif(not hasattr(socket, "SO_REUSEPORT"),
                    reason="SO_REUSEPORT not available")
def test_reuseport_sharded_ingest():
    n_workers, n_pub, n_frames = 2, 12, 20
    ctx = mp.get_context("spawn")   # fork would inherit the pytest threads
    qin = [ctx.Queue() for _ in range(n_workers)]
    qout = ctx.Queue()
    with socket.socket() as probe:   # free port
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    workers = [ctx.Process(target=_worker, args=(port, qin[i], qout),
                           daemon=True) for i in range(n_workers)]
    for w in workers:
        w.start()
    try:
        for _ in range(n_workers):
            kind, _pid, _ = qout.get(timeout=60)
            assert kind == "ready"

        import asyncio

        import numpy as np

        from swiftvideo_tpu_torch.core import EventBox, StepClock, TimePoint
        from swiftvideo_tpu_torch.media.coded import (CodedMediaSample,
                                                MediaFormat, MediaType)
        from swiftvideo_tpu_torch.net.rtmp import Rtmp

        async def publish() -> None:
            clock = StepClock(TimePoint(16, 1000))
            pubs = []
            for k in range(n_pub):
                client = Rtmp(clock)
                pub, _ = await client.connect(
                    f"rtmp://127.0.0.1:{port}/shard/cam{k}",
                    publish_to_peer=True, max_attempts=3, retry_delay=0.3)
                pubs.append(pub)
            for _ in range(14):          # 224 ms metadata grace
                clock.step()
                await asyncio.sleep(0.002)
            rng = np.random.default_rng(7)
            data = bytearray(rng.integers(0, 256, 4093, np.int64)
                             .astype(np.uint8).tobytes())
            data[4] = 0x65
            buf, config = bytes(data), bytes(48)
            ts = TimePoint(0, 1000)
            for _ in range(n_frames):
                for k, pub in enumerate(pubs):
                    pub.apply(EventBox.just(CodedMediaSample(
                        buffer=buf, pts_value=ts, dts_value=ts,
                        media_type=MediaType.video,
                        media_format=MediaFormat.avc,
                        id_asset=f"cam{k}", id_workspace="shard",
                        side={"config": config})))
                ts = ts + TimePoint(16, 1000)
                clock.step()
                await asyncio.sleep(0)
            await asyncio.sleep(0.2)     # flush write buffers
            for pub in pubs:
                pub.close()
            await asyncio.sleep(0.1)

        asyncio.run(publish())

        # poll workers until every frame is accounted for
        expected = n_pub * n_frames
        deadline = time.time() + 30.0
        per_worker: dict = {}
        while time.time() < deadline:
            for q in qin:
                q.put("report")
            got = {}
            for _ in range(n_workers):
                kind, pid, counts = qout.get(timeout=30)
                assert kind == "counts"
                got[pid] = counts
            per_worker = got
            if sum(sum(c.values()) for c in got.values()) >= expected:
                break
            time.sleep(0.2)

        all_counts: dict = {}
        for counts in per_worker.values():
            for path, n in counts.items():
                # each session lands on exactly ONE worker: no path may
                # appear on two workers
                assert path not in all_counts, f"{path} split across workers"
                all_counts[path] = n
        assert sum(all_counts.values()) == expected, per_worker
        assert len(all_counts) == n_pub
        assert all(n == n_frames for n in all_counts.values()), all_counts
    finally:
        for q in qin:
            q.put("stop")
        for w in workers:
            w.join(timeout=10)
            if w.is_alive():
                w.terminate()
