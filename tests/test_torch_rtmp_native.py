"""Twin of ``tests/test_rtmp_native.py`` on the port (``swiftvideo_tpu_torch``).

Native (C++) RTMP dechunker vs the pure-Python behavioral spec.

csrc/rtmp_chunks.cpp must match chunks.py::ChunkDeserializer message-for-
message on arbitrary wire streams — including extended timestamps, serial
rollover, interleaved chunk streams, mid-stream SetChunkSize, and the
pending-byte cap (reference semantics: deserialize.swift:24-101)."""

import random
import struct

import pytest

from swiftvideo_tpu_torch.net.rtmp.chunks import (Chunk, ChunkDeserializer,
                                            ChunkSerializer,
                                            native_available)

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="libsvrtmp.so not available")


def _random_messages(rng, count, csids=(4, 6, 300, 5000), big_ts=False):
    msgs, ts = [], 0
    for _ in range(count):
        ts += rng.choice([0, 16, 16, 33, 1000,
                          0x1000000 if big_ts else 16])
        size = rng.choice([0, 1, 7, 100, 128, 129, 4096, 20000])
        msgs.append(Chunk(
            msg_stream_id=rng.choice([0, 1]), msg_length=size,
            msg_type=rng.choice([8, 9, 18]),
            chunk_stream_id=rng.choice(csids),
            timestamp=ts, timestamp_delta=16,
            data=rng.randbytes(size)))
    return msgs


@pytest.mark.parametrize("chunk_size", [128, 4096])
@pytest.mark.parametrize("seed", [0, 1])
def test_native_matches_python_fuzz(chunk_size, seed):
    rng = random.Random(seed)
    ser = ChunkSerializer(out_chunk_size=chunk_size)
    msgs = _random_messages(rng, 300, big_ts=(seed == 1))
    wire = b"".join(ser.serialize(m) for m in msgs)
    dn = ChunkDeserializer(in_chunk_size=chunk_size, native=True)
    dp = ChunkDeserializer(in_chunk_size=chunk_size, native=False)
    assert dn.native and not dp.native
    outs_n, outs_p, i = [], [], 0
    while i < len(wire):
        n = rng.randint(1, 5000)
        piece = wire[i:i + n]
        i += n
        outs_n += dn.feed(piece)
        outs_p += dp.feed(piece)
    assert len(outs_n) == len(outs_p) == len(msgs)
    for a, b in zip(outs_n, outs_p):
        assert a == b


def test_native_mid_stream_chunk_size_change():
    """SetChunkSize applied between polls (session.py interleaving) must
    re-chunk subsequent parsing identically on both paths."""
    ser = ChunkSerializer(out_chunk_size=128)
    scs = Chunk(msg_stream_id=0, msg_length=4, msg_type=1,
                chunk_stream_id=2, timestamp=0,
                data=struct.pack(">I", 4096))
    wire = ser.serialize(scs)
    ser.set_chunk_size(4096)
    big = Chunk(msg_stream_id=1, msg_length=20000, msg_type=9,
                chunk_stream_id=6, timestamp=16, timestamp_delta=16,
                data=bytes(range(256)) * 78 + bytes(20000 - 78 * 256))
    wire += ser.serialize(big)
    results = []
    for native in (True, False):
        d = ChunkDeserializer(native=native)
        d.append(wire)
        got = []
        while True:
            c = d.poll()
            if c is None:
                break
            if c.msg_type == 1:
                d.set_chunk_size(struct.unpack(">I", c.data[:4])[0])
            got.append(c)
        results.append(got)
    assert results[0] == results[1]
    assert len(results[0]) == 2 and results[0][1].data == big.data


def test_native_pending_cap_raises():
    d = ChunkDeserializer(max_pending=1 << 16, native=True)
    # type-3 continuation on an unknown chunk stream: parse stalls forever
    garbage = bytes([0xC6]) + bytes(1 << 16)
    d.append(garbage)
    with pytest.raises(ValueError, match="exceeded"):
        d.poll()


def test_native_pending_property():
    d = ChunkDeserializer(native=True)
    assert d.pending == 0
    d.append(b"\x06")          # lone basic header: stalls
    assert d.poll() is None
    assert d.pending == 1


def test_native_extended_timestamp_small_value_flag():
    """A peer that uses extended encoding for values < 0xFFFFFF: the
    wire-tracked flag must carry into type-3 continuations (round-3 fix,
    proven equivalent on the native path)."""
    # hand-build: type-0, csid 6, ext marker with full ts = 100, len 300
    hdr = bytes([0x06]) + b"\xff\xff\xff" + struct.pack(">I", 300)[1:] \
        + bytes([9]) + struct.pack("<I", 1) + struct.pack(">I", 100)
    body = bytes(range(256)) + bytes(44)
    wire = hdr + body[:128] + bytes([0xC6]) + struct.pack(">I", 100) \
        + body[128:256] + bytes([0xC6]) + struct.pack(">I", 100) + body[256:]
    for native in (True, False):
        d = ChunkDeserializer(native=native)
        out = d.feed(wire)
        assert len(out) == 1, f"native={native}"
        assert out[0].timestamp == 100 and out[0].extended
        assert out[0].data == body
