"""Host ms a video frame inside ``AudioMixer._mix`` (every 10 ms audio
tick: placement, the s16 fold, the mixed sample's emission)."""

SPANS = (("audio_mixer", "swiftvideo_tpu_torch.mix.audio_mixer",
          "AudioMixer._mix"),)


def read(run):
    if not run.frames or not run.spans.calls("audio_mixer"):
        return None
    return run.spans.seconds("audio_mixer") * 1e3 / run.frames
