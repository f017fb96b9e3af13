"""Faults planted in the motion cells' timed path, for the check's tests:
each name maps to (module of the program, function, wrapper maker).  The
wrapper maker takes the function and returns the faulty one.  Each wraps
the compute registry's entry, which both motion kernels go through."""

import torch

RUN = ("swiftvideo_tpu_torch.ops.registry", "run_compute_kernel")


def _unchanged(run):
    """Every camera's first map, handed out again on every later tick."""
    first = {}

    def faulty(ctx, images, target, kernel, *args, **kwargs):
        out = run(ctx, images, target, kernel, *args, **kwargs)
        return first.setdefault(target.asset_id(), out)
    return faulty


def _previous_is_current(run):
    def faulty(ctx, images, target, kernel, *args, **kwargs):
        return run(ctx, [images[0], images[0]], target, kernel, *args,
                   **kwargs)
    return faulty


def _altered(run):
    def faulty(ctx, images, target, kernel, *args, **kwargs):
        out = run(ctx, images, target, kernel, *args, **kwargs)
        mv = out.planes()[0].clone()
        mv[0, 0, 0] += 1
        return out.with_(img=out.img.with_buffers([mv]))
    return faulty


def _coarse_only(run):
    """The coarse stage's picks on the stride-2 grid emitted as the map,
    with no exact re-score around them."""
    from swiftvideo_tpu_torch.ops import motion

    def faulty(ctx, images, target, kernel, *args, **kwargs):
        out = run(ctx, images, target, kernel, *args, **kwargs)
        cur, ref = images[0].planes()[0], images[1].planes()[0]
        raw = motion.me_coarse(cur, ref, 16, 64, 2).long()
        lut = torch.from_numpy(motion.tables(16, 64)[3]).to(cur.device)
        r, b = (lut[torch.clamp(raw[..., i], -32, 32) + 32]
                for i in (0, 1))
        mv = torch.stack([r, torch.full_like(r, 128), b,
                          torch.full_like(r, 255)], dim=-1)
        return out.with_(img=out.img.with_buffers([mv]))
    return faulty


FAULTS = {"map unchanged across ticks": (*RUN, _unchanged),
          "previous frame replaced by the current": (*RUN,
                                                     _previous_is_current),
          "one block's vector altered": (*RUN, _altered),
          "refine skipped, coarse picks only": (*RUN, _coarse_only)}
