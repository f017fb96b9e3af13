"""Host us a tick inside ``MixingWall.step``, less the cell wrapper
(``frame.composite_cells_cuda``) inside it: the step's checks, the audio's
torch ops and the output's assembly."""

SPANS = (("wall", "swiftvideo_tpu_torch.parallel.wall", "MixingWall.step"),
         ("cells", "swiftvideo_tpu_torch.ops.frame", "composite_cells_cuda"))


def read(run):
    s = run.spans
    if not run.frames or not s.calls("wall"):
        return None
    return (s.seconds("wall") - s.seconds("cells")) * 1e6 / run.frames
