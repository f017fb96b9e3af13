"""Host us a tick inside the cell wrapper ``frame.composite_cells_cuda``
(checks, the launch table, the pointers, the launches)."""

SPANS = (("cells", "swiftvideo_tpu_torch.ops.frame", "composite_cells_cuda"),)


def read(run):
    s = run.spans
    if not run.frames or not s.calls("cells"):
        return None
    return s.seconds("cells") * 1e6 / run.frames
