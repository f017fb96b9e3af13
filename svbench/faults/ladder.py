"""Faults planted in the ladder's timed path, for the check's tests: each
name maps to (module of the program, function, wrapper maker).  The
wrapper maker takes the function and returns the faulty one.  Each wraps
the cell wrapper, which every rung goes through: on the card inside
``matscale.scale_ladder``, on the CPU from the driver."""

import torch

CELLS = ("swiftvideo_tpu_torch.ops.frame", "composite_cells_cuda")


def _rung_unwritten(cells):
    """The first rung's canvas left as cleared: luma 0, chroma 128."""
    first = []

    def faulty(cell_size, planes, fmt, uniforms, **kwargs):
        out = cells(cell_size, planes, fmt, uniforms, **kwargs)
        if not first:
            first.append(tuple(cell_size))
        if tuple(cell_size) != first[0]:
            return out
        return [torch.zeros_like(out[0]), torch.full_like(out[1], 128),
                torch.full_like(out[2], 128)]
    return faulty


def _channel_swapped(cells):
    """Channels 0 and 1 of the batch trade frames."""
    def faulty(cell_size, planes, fmt, uniforms, **kwargs):
        planes = [p[[1, 0] + list(range(2, p.shape[0]))] for p in planes]
        return cells(cell_size, planes, fmt, uniforms, **kwargs)
    return faulty


def _altered(cells):
    def faulty(cell_size, planes, fmt, uniforms, **kwargs):
        out = cells(cell_size, planes, fmt, uniforms, **kwargs)
        out[0][0, 0] += 1
        return out
    return faulty


FAULTS = {"a rung left unwritten": (*CELLS, _rung_unwritten),
          "a channel's frame swapped": (*CELLS, _channel_swapped),
          "one pixel altered": (*CELLS, _altered)}
