"""swiftvideo_tpu_torch — the PyTorch / CUDA port of swiftvideo_tpu.

The live mixing tick of ``swiftvideo_tpu`` (Composer -> GPUBarrierUpload
-> Repeater -> PictureAnimator -> VideoMixer, and the SRC -> SoundAnimator
-> AudioMixer audio leg) on torch tensors with an explicit
``torch.device``.  On an NVIDIA Hopper card the frame composite is one
launch of a hand-written CUDA kernel (ops/frame.py,
csrc/frame_composite.cu); on the CPU it is a plain torch version of the
golden per-pixel algorithm (ops/composite.py).

The host layers that never import JAX — ``swiftvideo_tpu.core``,
``.media``, ``.scene``, ``.utils`` and ``.net`` — are shared by import.
Nothing here imports JAX, and nothing imports ``triton``.

Layer map (mirrors ``swiftvideo_tpu``):
  ops/      — registry, barriers, audio folds, plain composite, frame kernel
  mix/      — VideoMixer, AudioMixer, animators, repeater, SRC, audio stats
  compose/  — Composer + scene-graph manifests
  interop   — the JAX package's source lists as this package's tensors
"""

__version__ = "0.1.0"
