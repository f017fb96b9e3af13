"""Host ms a video frame of the live station's graph itself: every clock
step and the inputs' publishing, less the spans inside them that other
metrics read (the uploads, the audio mixer's tick, the video mixer's tick
with the sink)."""

SPANS = (("upload", "swiftvideo_tpu_torch.ops.barriers", "upload"),
         ("audio_mixer", "swiftvideo_tpu_torch.mix.audio_mixer",
          "AudioMixer._mix"),
         ("video_mixer", "swiftvideo_tpu_torch.mix.video_mixer",
          "VideoMixer._mix"))


def read(run):
    s = run.spans
    if not run.frames or not s.calls("step"):
        return None
    own = (s.seconds("feed") + s.seconds("step") - s.seconds("upload")
           - s.seconds("audio_mixer") - s.seconds("video_mixer"))
    return own * 1e3 / run.frames
