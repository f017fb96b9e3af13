"""Output frames completed in the window over the window's seconds."""


def read(run):
    return run.frames / run.window_s
