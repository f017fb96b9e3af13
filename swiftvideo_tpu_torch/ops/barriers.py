"""Host<->device transfer barriers as graph stages.

Reference semantics: ``GPUBarrierUpload`` / ``GPUBarrierDownload``
(compute.swift:175-255) with ``gpu.upload`` / ``gpu.download`` timers, plus
the audio barrier pair the reference left dormant (compute.swift:200-282).

Uploads copy each plane into page-locked host memory and then to the
context's device with ``non_blocking=True``, so the copy overlaps the
host's next work.  PyTorch's pinned allocator records the copy on the
stream and keeps the page-locked block from reuse until it has run.  On a
cpu context the planes become torch tensors that share the numpy memory.
Downloads materialize numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import EventBox, Tx, spans
from ..media.audio import AudioSample
from ..media.picture import BufferType, PictureSample

from .registry import ComputeContext


def _host_tensor(array) -> torch.Tensor:
    if isinstance(array, torch.Tensor):
        return array
    a = np.ascontiguousarray(array)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def upload(array, device: torch.device) -> torch.Tensor:
    """One host buffer (numpy or cpu tensor) as a tensor on ``device``."""
    if isinstance(array, torch.Tensor) and array.device == device:
        return array
    if device.type == "cpu":
        return _host_tensor(array)
    span = spans.ON and spans.begin("barriers.upload")
    part = span and spans.begin("barriers.pin")
    t = _host_tensor(array).pin_memory()
    if span:
        spans.end(part)
        spans.count("barriers.uploads")
        spans.count("barriers.upload_bytes", t.nbytes)
        part = spans.begin("barriers.h2d")
    t = t.to(device, non_blocking=True)
    if span:
        spans.end(part)
        spans.end(span)
    return t


def download(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class GPUBarrierUpload(Tx):
    """Move PictureSample planes to the context's device
    (compute.swift:175-198)."""

    def __init__(self, ctx: ComputeContext):
        self._ctx = ctx
        super().__init__(self._impl)

    def _impl(self, sample: PictureSample) -> EventBox:
        if sample.buffer_type() == BufferType.gpu:
            return EventBox.just(sample)
        info = sample.info()
        if info is not None:
            info.start_timer("gpu.upload")
        device = self._ctx.device
        buffers = tuple(upload(p, device) for p in sample.planes())
        btype = BufferType.gpu if device.type == "cuda" else BufferType.cpu
        img = sample.img.with_buffers(buffers, btype)
        if info is not None:
            info.end_timer("gpu.upload")
        return EventBox.just(sample.with_(img=img))


class GPUBarrierDownload(Tx):
    """Materialize device planes back to host (compute.swift:230-255)."""

    def __init__(self, ctx: ComputeContext):
        self._ctx = ctx
        super().__init__(self._impl)

    def _impl(self, sample: PictureSample) -> EventBox:
        if sample.buffer_type() == BufferType.cpu:
            return EventBox.just(sample)
        info = sample.info()
        if info is not None:
            info.start_timer("gpu.download")
        buffers = tuple(download(p) for p in sample.planes())
        img = sample.img.with_buffers(buffers, BufferType.cpu)
        if info is not None:
            info.end_timer("gpu.download")
        return EventBox.just(sample.with_(img=img))


class GPUBarrierAudioUpload(Tx):
    """Audio device upload (the reference's dormant audio barrier,
    compute.swift:200-227, made functional)."""

    def __init__(self, ctx: ComputeContext):
        self._ctx = ctx
        super().__init__(self._impl)

    def _impl(self, sample: AudioSample) -> EventBox:
        if sample.compute_buffers is not None:
            return EventBox.just(sample)
        buffers = tuple(upload(b, self._ctx.device) for b in sample.buffers)
        return EventBox.just(sample.with_(compute_buffers=buffers))


class GPUBarrierAudioDownload(Tx):
    def __init__(self, ctx: ComputeContext):
        self._ctx = ctx
        super().__init__(self._impl)

    def _impl(self, sample: AudioSample) -> EventBox:
        if sample.compute_buffers is None:
            return EventBox.just(sample)
        buffers = tuple(download(b) for b in sample.compute_buffers)
        return EventBox.just(sample.with_(buffers=buffers, compute_buffers=None))
