"""Host ms a video frame in the audio mixer's ticks less their emission
(the program's ``audio_mixer.tick`` less ``audio_mixer.emit``): the
placement, the fold and the tick's timers, not the mixed sample's way
downstream."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    if rec is None:
        return None
    return program.per_frame(
        run, rec.total_ns("audio_mixer.tick")
        - rec.total_ns("audio_mixer.emit", inside="audio_mixer.tick"), 1e6)
