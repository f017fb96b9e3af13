"""Compute front-end: kernel naming, context, and the run/apply entry points.

Reference semantics: SwiftVideo's ``Sources/SwiftVideo/compute.swift``
(ComputeKernel enum :49-74, kernel-name map :90-110, makeComputeContext :121,
applyComputeImage :145-170), as ported by ``swiftvideo_tpu/ops/registry.py``.

Kernels keep the ``img_<inFmt>_<outFmt>`` naming.  A context holds an
explicit ``torch.device``, the card unless the caller asks for the CPU: on
``cuda`` a composite onto any yuv (packed 4:2:2 through y422p) or RGBA /
BGRA target runs the frame kernel (ops/frame.py) and any other target
raises; on ``cpu`` everything runs the plain torch version
(ops/composite.py).
``me_fullsearch`` / ``me_fullsearch_ssd`` run the motion search and
``me_fullsearch_pyramid`` the two-stage search with its defaults
(ops/motion.py).  ``custom``
kernels are user-registered callables (compute.swift .custom case).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

from ..media.picture import BufferType, ImageBuffer, PictureSample
from ..media.pixel import PixelFormat, planar_to_packed422, planes_for_format

from . import composite, frame, motion
from .uniforms import ImageUniforms

_FMT_NAMES = {
    PixelFormat.y420p: "y420p", PixelFormat.nv12: "nv12",
    PixelFormat.nv21: "nv21", PixelFormat.RGBA: "rgba",
    PixelFormat.BGRA: "bgra", PixelFormat.y422p: "y422p",
    PixelFormat.y444p: "y444p",
}
_NAME_FMTS = {v: k for k, v in _FMT_NAMES.items()}
_MOTION = ("me_fullsearch", "me_fullsearch_ssd", "me_fullsearch_pyramid")


class ComputeError(Exception):
    pass


@dataclass(frozen=True)
class ComputeKernel:
    """A kernel identity: composite conversion, clear, audio, motion, or
    custom (compute.swift:49-74)."""

    name: str

    @staticmethod
    def composite(in_fmt: PixelFormat, out_fmt: PixelFormat) -> "ComputeKernel":
        return ComputeKernel(f"img_{_FMT_NAMES[in_fmt]}_{_FMT_NAMES[out_fmt]}")

    @staticmethod
    def clear(fmt: PixelFormat) -> "ComputeKernel":
        return ComputeKernel(f"img_clear_{_FMT_NAMES[fmt]}")

    @staticmethod
    def custom(name: str) -> "ComputeKernel":
        return ComputeKernel(name)


def default_compute_kernel_from_string(name: str) -> ComputeKernel:
    """Kernel-name lookup (compute.swift:90-110).  img_clear_rgba aliases
    img_clear_bgra like the reference; composite names must parse to known
    formats."""
    if name == "img_clear_rgba":
        name = "img_clear_bgra"
    parts = name.split("_")
    if len(parts) == 3 and parts[0] == "img":
        if parts[1] == "clear":
            if parts[2] not in _NAME_FMTS:
                raise ComputeError(f"invalid kernel {name}")
        elif parts[1] not in _NAME_FMTS or parts[2] not in _NAME_FMTS:
            raise ComputeError(f"invalid kernel {name}")
        return ComputeKernel(name)
    if name == "snd_s16i_s16i" or name in _MOTION:
        return ComputeKernel(name)
    raise ComputeError(f"invalid kernel {name}")


@dataclass
class ComputeContext:
    """Device context (makeComputeContext, compute.swift:121): the torch
    device every op of the context runs on, plus user kernels."""

    device: torch.device
    logger: Optional[object] = None
    custom_kernels: Dict[str, Callable] = field(default_factory=dict)
    ident: str = field(default_factory=lambda: str(uuid.uuid4()))

    @property
    def kind(self) -> str:
        """``cuda`` (the hand-written kernels) or ``cpu`` (plain torch)."""
        return self.device.type

    def register_kernel(self, name: str, fn: Callable) -> None:
        self.custom_kernels[name] = fn


def has_available_compute_devices() -> bool:
    return torch.cuda.is_available()


def make_compute_context(device=None) -> ComputeContext:
    """A context on ``device``, by default the current CUDA card.  A cuda
    device needs a card: there is no silent downgrade to the CPU, which a
    caller asks for with ``"cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise ComputeError("deviceNotAvailable: no CUDA device")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ComputeError(f"unsupported device {device}")
    return ComputeContext(device=device)


def begin_compute_pass(ctx: ComputeContext) -> ComputeContext:
    return ctx


def end_compute_pass(ctx: ComputeContext, wait: bool = False) -> ComputeContext:
    """endComputePass (compute.cl.swift:346-359): with ``wait`` the host
    blocks until the context's device has finished its queued work."""
    if wait and ctx.kind == "cuda":
        torch.cuda.synchronize(ctx.device)
    return ctx


def using_context(ctx: ComputeContext, fn) -> ComputeContext:
    return end_compute_pass(fn(begin_compute_pass(ctx)), True)


def composite_frame(ctx: ComputeContext, out_fmt: PixelFormat, size,
                    sources, target=None):
    """Fold ``sources`` onto a cleared (or the given) ``out_fmt`` frame on
    the context's device: the frame kernel on the card, the plain version
    on the CPU.  Packed 4:2:2 (yuvs / zvuy) sources reach the kernel
    unpacked to y422p; a packed target is unpacked, folds as y422p and is
    packed again, by torch ops on the card.  On the card a target the
    kernel does not write raises."""
    if ctx.kind != "cuda":
        return composite.composite_stack_torch(out_fmt, size, sources,
                                               ctx.device, target=target)
    sources = composite.unpack_sources(sources)
    if out_fmt not in composite.PACKED_422:
        return frame.composite_frame_cuda(size, sources, out_fmt,
                                          device=ctx.device, target=target)
    if target is not None:
        target = composite._unpack(target[0], out_fmt)
    planes = frame.composite_frame_cuda(size, sources, PixelFormat.y422p,
                                        device=ctx.device, target=target)
    return [planar_to_packed422(planes, out_fmt, torch)]


def to_device(planes, device: torch.device):
    return [torch.as_tensor(p, device=device) for p in planes]


# --- kernel execution -----------------------------------------------------

def run_compute_kernel(ctx: ComputeContext, images, target: PictureSample,
                       kernel: ComputeKernel, uniforms=None,
                       blends: bool = True) -> PictureSample:
    """Run one named kernel (compute.cl.swift:264-344 equivalent).

    Composite kernels read ``images[0]`` + the current target planes and
    return a new target sample; clear kernels reset the target.
    """
    name = kernel.name
    if name in ctx.custom_kernels:
        return ctx.custom_kernels[name](ctx, images, target, uniforms)
    parts = name.split("_")
    if parts[0] == "img" and parts[1] == "clear":
        planes = composite.clear_planes(target.pixel_format(), target.size(),
                                        ctx.device)
        return target.with_(img=target.img.with_buffers(planes))
    if name in _MOTION:
        # images = [current, reference] luma samples; an RGBA MV map at
        # block resolution comes back (kernels.metal:206-267)
        if len(images) < 2:
            raise ComputeError("badInputData")
        cur, ref = to_device([images[0].planes()[0], images[1].planes()[0]],
                             ctx.device)
        if name == "me_fullsearch_pyramid":
            mv = motion.me_fullsearch_pyramid(cur, ref)
        else:
            mv = motion.me_fullsearch(
                cur, ref, metric="ssd" if name.endswith("_ssd") else "sad")
        h, w = mv.shape[:2]
        img = ImageBuffer(pixel_format=PixelFormat.RGBA,
                          buffer_type=(BufferType.gpu if ctx.kind == "cuda"
                                       else BufferType.cpu),
                          size=(w, h),
                          planes=tuple(planes_for_format(PixelFormat.RGBA,
                                                         (w, h))),
                          buffers=(mv,))
        return target.with_(img=img)
    if name == "snd_s16i_s16i":
        raise ComputeError("snd_s16i_s16i runs via ops.audio.mix_s16_device")
    if parts[0] == "img":
        if not images:
            raise ComputeError("badInputData")
        image = images[0]
        in_fmt = _NAME_FMTS[parts[1]]
        out_fmt = _NAME_FMTS[parts[2]]
        if image.pixel_format() != in_fmt or target.pixel_format() != out_fmt:
            raise ComputeError(
                f"kernel {name} vs formats {image.pixel_format()}/{target.pixel_format()}")
        uni = uniforms if uniforms is not None else \
            ImageUniforms.from_sample(image, target)
        sources = [(to_device(image.planes(), ctx.device), in_fmt, uni)]
        planes = composite_frame(ctx, out_fmt, target.size(), sources,
                                 target=to_device(target.planes(), ctx.device))
        return target.with_(img=target.img.with_buffers(planes))
    raise ComputeError(f"computeKernelNotFound: {name}")


def apply_compute_image(ctx: ComputeContext, image: PictureSample,
                        target: PictureSample,
                        kernel: Optional[ComputeKernel] = None) -> PictureSample:
    """Composite ``image`` over ``target`` with the sample's own matrices
    (applyComputeImage, compute.swift:145-170)."""
    if kernel is None:
        kernel = ComputeKernel.composite(image.pixel_format(),
                                         target.pixel_format())
    uni = ImageUniforms.from_sample(image, target)
    return run_compute_kernel(ctx, [image], target, kernel, uni, blends=True)
