"""Host ms a video frame in the program's clock steps and bus appends
themselves (their self time: ``clock.step`` and ``bus.append`` less the
spans inside them): the clock's scheduling, the buses' locks and fan-out,
the asset filters and the graph's ``Tx`` and ``EventBox`` plumbing."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    if rec is None:
        return None
    return program.per_frame(
        run, rec.self_ns("clock.step", "bus.append"), 1e6)
