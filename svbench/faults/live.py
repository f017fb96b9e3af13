"""Faults planted in the live station's timed path, for the check's tests:
each name maps to (module of the program, function, wrapper maker).  The
wrapper maker takes the function and returns the faulty one."""


def _stale_frame(orig):
    first = []

    def composite(ctx, fmt, size, sources, target=None):
        out = orig(ctx, fmt, size, sources, target)
        if not first:
            first.append([p.clone() for p in out])
        return [p.clone() for p in first[0]]
    return composite


def _half_sources(orig):
    def composite(ctx, fmt, size, sources, target=None):
        return orig(ctx, fmt, size, sources[:(len(sources) + 1) // 2],
                    target)
    return composite


def _altered_pixel(orig):
    def composite(ctx, fmt, size, sources, target=None):
        out = orig(ctx, fmt, size, sources, target)
        out[0][0, 0] += 1
        return out
    return composite


def _mix_unchanged(orig):
    def mix(input_buf, gains, backing, backing_start=0, input_start=0):
        return 0
    return mix


def _half_assets(orig):
    calls = [0]

    def mix(input_buf, gains, backing, backing_start=0, input_start=0):
        calls[0] += 1
        if calls[0] % 2:
            return orig(input_buf, gains, backing, backing_start, input_start)
        return 0
    return mix


def _altered_sample(orig):
    def mix(input_buf, gains, backing, backing_start=0, input_start=0):
        n = orig(input_buf, gains, backing, backing_start, input_start)
        backing[backing_start] += 1
        return n
    return mix


FAULTS = {
    "video state unchanged": ("swiftvideo_tpu_torch.mix.video_mixer",
                              "composite_frame", _stale_frame),
    "video half the sources": ("swiftvideo_tpu_torch.mix.video_mixer",
                               "composite_frame", _half_sources),
    "video pixel altered": ("swiftvideo_tpu_torch.mix.video_mixer",
                            "composite_frame", _altered_pixel),
    "audio state unchanged": ("swiftvideo_tpu_torch.mix.audio_mixer",
                              "apply_mix_s16", _mix_unchanged),
    "audio half the assets": ("swiftvideo_tpu_torch.mix.audio_mixer",
                              "apply_mix_s16", _half_assets),
    "audio sample altered": ("swiftvideo_tpu_torch.mix.audio_mixer",
                             "apply_mix_s16", _altered_sample),
}
