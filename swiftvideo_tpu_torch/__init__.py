"""swiftvideo_tpu_torch — the PyTorch / CUDA port of swiftvideo_tpu.

The live mixing tick of ``swiftvideo_tpu`` (Composer -> GPUBarrierUpload
-> Repeater -> PictureAnimator -> VideoMixer, and the SRC -> SoundAnimator
-> AudioMixer audio leg) and its motion search, on torch tensors with an
explicit ``torch.device``: the CUDA card unless the caller asks for
``"cpu"``.  On an NVIDIA Hopper card the frame composite (yuv and RGBA /
BGRA targets) is one launch of a hand-written CUDA kernel (ops/frame.py,
csrc/frame_composite.cu) and the motion search another
(ops/motion.py, csrc/motion_search.cu); on the CPU both are plain torch
versions of the reference algorithms.

The package keeps its own copies of the host layers it needs (core,
media, scene, utils).  Nothing here imports JAX, ``triton`` or the JAX
package.

Layer map (mirrors ``swiftvideo_tpu``):
  core/     — TimePoint, clocks, EventBox, Tx/Bus graph, stats
  media/    — pixel formats, PictureSample, AudioSample, coded samples
  scene.py  — compositions, elements, commands
  utils/    — 4x4 / 3x3 matrices
  ops/      — registry, barriers, audio folds, plain composite, frame
              kernel, motion search, nvcc build
  mix/      — VideoMixer, AudioMixer, animators, repeater, SRC, audio stats
  compose/  — Composer + scene-graph manifests
  interop   — the JAX package's formats, uniforms, samples and source
              lists as this package's
"""

__version__ = "0.1.0"
