"""Host us a video frame in the graph's per-element stages, by the
program's spans (self time): the repeaters, the picture and sound
animators and the sample rate conversions."""

from svbench import program

SPANS = program.ARM
STAGES = ("stage.repeater", "stage.picture_animator", "stage.sound_animator",
          "stage.src")


def read(run):
    rec = program.records(run)
    if rec is None:
        return None
    return program.per_frame(run, rec.self_ns(*STAGES), 1e3)
