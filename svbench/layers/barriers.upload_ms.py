"""Host ms a video frame inside ``barriers.upload`` (page-locked copy and
the host-to-device copy's enqueue); nothing to read where the cameras are
already on the card."""

SPANS = (("upload", "swiftvideo_tpu_torch.ops.barriers", "upload"),)


def read(run):
    if not run.frames or not run.spans.calls("upload"):
        return None
    return run.spans.seconds("upload") * 1e3 / run.frames
