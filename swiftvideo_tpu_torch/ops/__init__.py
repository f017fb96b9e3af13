"""Device compute: kernel registry, plain torch versions, Hopper kernels."""

from .color import RGB2YUV, YUV2RGB, rgb_to_yuv, yuv_to_rgb
from .uniforms import (UNIFORM_WIDTH, ImageUniforms, identity_uniforms,
                       rect_uniforms)
from . import composite, frame, motion
from .registry import (ComputeContext, ComputeError, ComputeKernel,
                       apply_compute_image, begin_compute_pass,
                       default_compute_kernel_from_string, end_compute_pass,
                       has_available_compute_devices, make_compute_context,
                       run_compute_kernel, using_context)
from .barriers import (GPUBarrierAudioDownload, GPUBarrierAudioUpload,
                       GPUBarrierDownload, GPUBarrierUpload)

__all__ = [
    "RGB2YUV", "YUV2RGB", "rgb_to_yuv", "yuv_to_rgb",
    "ImageUniforms", "UNIFORM_WIDTH", "identity_uniforms", "rect_uniforms",
    "composite", "frame", "motion",
    "ComputeContext", "ComputeError", "ComputeKernel",
    "make_compute_context", "has_available_compute_devices",
    "default_compute_kernel_from_string", "run_compute_kernel",
    "apply_compute_image", "begin_compute_pass", "end_compute_pass",
    "using_context",
    "GPUBarrierUpload", "GPUBarrierDownload",
    "GPUBarrierAudioUpload", "GPUBarrierAudioDownload",
]
