"""RTMP server example on the PyTorch/CUDA port: accept publishers, count
their media.  The flow of ``examples/rtmp_server_demo.py``; host-only.

Role parity with Examples/RtmpServer/main.swift: serve
RTMP, accept every connection, subscribe to published media. A loopback
client publishes a short synthetic stream to demonstrate.

Run: python examples/torch_rtmp_server_demo.py [port]
"""

import asyncio
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from swiftvideo_tpu_torch.core import EventBox, TimePoint, Tx, WallClock
from swiftvideo_tpu_torch.media import CodedMediaSample, MediaFormat, MediaType
from swiftvideo_tpu_torch.net.rtmp import Rtmp


async def main(port: int = 1935) -> None:
    received = []
    chains = []

    async def on_connection(pub, sub):
        if sub is not None:
            print(f"publisher connected: playPath={sub.play_path()}")
            chains.append(sub >> Tx(
                lambda s: (received.append(s), EventBox.nothing(None))[1]))
        return True

    clock = WallClock()
    server = Rtmp(clock, on_connection=on_connection,
                  on_ended=lambda a: print("ended:", a))
    await server.serve("127.0.0.1", port)
    print(f"rtmp server on 127.0.0.1:{port}")

    # loopback publisher
    client = Rtmp(clock)
    pub, _ = await client.connect(f"rtmp://127.0.0.1:{port}/live/demo",
                                  max_attempts=2, retry_delay=0.5)
    await asyncio.sleep(0.3)  # metadata grace timer
    rng = np.random.default_rng(0)
    for i in range(30):
        payload = bytearray(rng.integers(0, 256, 5000, np.int64)
                            .astype(np.uint8).tobytes())
        payload[4] = 0x65
        pub.apply(EventBox.just(CodedMediaSample(
            buffer=bytes(payload), pts_value=TimePoint(i * 33, 1000),
            dts_value=TimePoint(i * 33, 1000), media_type=MediaType.video,
            media_format=MediaFormat.avc, id_asset="demo",
            side={"config": bytes(48)})))
        await asyncio.sleep(0.01)
    # drain until every published sample arrived or delivery stops
    # growing, rather than a fixed sleep a loaded CI host can outrun
    loop = asyncio.get_event_loop()
    deadline = loop.time() + 10.0
    last, last_change = len(received), loop.time()
    while len(received) < 30 and loop.time() < deadline:
        await asyncio.sleep(0.02)
        if len(received) != last:
            last, last_change = len(received), loop.time()
        elif loop.time() - last_change > 1.0:
            break
    print(f"server received {len(received)} media samples")
    pub.close()
    await server.close()


if __name__ == "__main__":
    asyncio.run(main(int(sys.argv[1]) if len(sys.argv) > 1 else 1935))
