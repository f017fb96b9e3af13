"""Host us a video frame inside ``VideoMixer._mix`` (merge, z-sort,
uniforms, the frame wrapper and the kernel's launch), less the sink that
waits for the frame inside the mixer's emission."""

SPANS = (("video_mixer", "swiftvideo_tpu_torch.mix.video_mixer",
          "VideoMixer._mix"),)


def read(run):
    s = run.spans
    if not run.frames or not s.calls("video_mixer"):
        return None
    return (s.seconds("video_mixer") - s.seconds("sink")) * 1e6 / run.frames
