"""Host us a video frame in the video mixer's ticks less their emission
(the program's ``video_mixer.tick`` less ``video_mixer.emit``): the merge,
the z-sort, the uniforms, the frame wrapper and the kernel's launch, not
the mixed frame's way downstream."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    if rec is None:
        return None
    return program.per_frame(
        run, rec.total_ns("video_mixer.tick")
        - rec.total_ns("video_mixer.emit", inside="video_mixer.tick"), 1e3)
