"""Faults planted in the wall's timed path, for the check's tests: each
name maps to (module of the program, method, wrapper maker).  The wrapper
maker takes the method and returns the faulty one."""

STEP = ("swiftvideo_tpu_torch.parallel.wall", "MixingWall.step")


def _unchanged(step):
    first = []

    def faulty(self, *args, **kwargs):
        out = step(self, *args, **kwargs)
        if not first:
            first.append(tuple(t.clone() for t in out))
        return tuple(t.clone() for t in first[0])
    return faulty


def _half_streams(step):
    def faulty(self, ys, us, vs, audio, gains=None, uniforms=None):
        half = ys.shape[0] // 2
        ys, us, vs = ys.clone(), us.clone(), vs.clone()
        audio = audio.clone()
        for t in (ys, us, vs, audio):
            t[half:] = 0
        return step(self, ys, us, vs, audio, gains, uniforms)
    return faulty


def _altered(step):
    def faulty(self, *args, **kwargs):
        y, u, v, a = step(self, *args, **kwargs)
        y = y.clone()
        y[0, 0] += 1
        return y, u, v, a
    return faulty


def _audio_altered(step):
    def faulty(self, *args, **kwargs):
        y, u, v, a = step(self, *args, **kwargs)
        a = a.clone()
        a[0] += 1
        return y, u, v, a
    return faulty


FAULTS = {"state unchanged": (*STEP, _unchanged),
          "half the streams": (*STEP, _half_streams),
          "canvas pixel altered": (*STEP, _altered),
          "audio sample altered": (*STEP, _audio_altered)}
