"""Faults planted in the audio ingest's timed path, for the check's tests:
each name maps to (module of the program, function, wrapper maker).  The
wrapper maker takes the function and returns the faulty one.  Each wraps
a step every stream's conversion goes through: the resampler's
``process``, the stage's ``_convert`` or its s16 encoding."""

import numpy as np

PROCESS = ("swiftvideo_tpu_torch.ops.resample", "PolyphaseResampler.process")
CONVERT = ("swiftvideo_tpu_torch.mix.src_audio",
           "AudioSampleRateConversion._convert")
ENCODE = ("swiftvideo_tpu_torch.mix.src_audio", "from_planar_f32")


def _fifo_dropped(process):
    """One resampler's FIFO and bookkeeping dropped at the fifth call, as
    if the stream had started anew there."""
    calls = [0]

    def faulty(self, x):
        calls[0] += 1
        if calls[0] == 5:
            self._state = None
        return process(self, x)
    return faulty


def _outputs_swapped(convert):
    """The first two stages' outputs of each tick trade samples (the
    driver reads a tick's outputs after every stage has run)."""
    order, held = [], []

    def faulty(self, sample):
        out = convert(self, sample)
        got = out.value()
        if got is None:
            return out
        if len(order) < 2 and not any(self is o for o in order):
            order.append(self)
        if self is order[0]:
            held[:] = [got]
        elif len(order) > 1 and self is order[1] and held:
            for a, b in zip(held.pop().data(), got.data()):
                if a.shape == b.shape:
                    a[...], b[...] = b.copy(), a.copy()
        return out
    return faulty


def _pts_shifted(convert):
    """The third emitted sample's pts one sample late."""
    from swiftvideo_tpu_torch.core import EventBox, TimePoint
    emitted = [0]

    def faulty(self, sample):
        out = convert(self, sample)
        got = out.value()
        if got is None:
            return out
        emitted[0] += 1
        if emitted[0] != 3:
            return out
        pts = got.pts()
        return EventBox.just(got.with_(pts=pts + TimePoint(1, pts.scale)))
    return faulty


def _sample_off(encode):
    """Every emitted sample's first s16 value 2 LSB off."""
    def faulty(x, fmt):
        out = encode(x, fmt)
        if out and out[0].size:
            out[0][0] = np.int16(int(out[0][0]) + (2 if out[0][0] < 0
                                                   else -2))
        return out
    return faulty


FAULTS = {"a FIFO dropped once mid-stream": (*PROCESS, _fifo_dropped),
          "two streams' outputs swapped": (*CONVERT, _outputs_swapped),
          "one pts shifted by one sample": (*CONVERT, _pts_shifted),
          "one sample off by 2 LSB": (*ENCODE, _sample_off)}
