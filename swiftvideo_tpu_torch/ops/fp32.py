"""The float32 rule of the port's sampling products.

The transcode ladder and the wall's plan path (ops/matscale.py) and the
device resampler (ops/resample.py) are float32 matrix products whose
contracts (<= 1 LSB against golden; < 1e-4 against the host resampler)
hold only in full float32.  PyTorch's global switches
(``torch.backends.cuda.matmul.allow_tf32``,
``torch.set_float32_matmul_precision``) can send such a product to TF32
(10-bit mantissa) or bf16, which would lose the contract without a word.
The products check the switches before every call and raise instead.
"""

from __future__ import annotations

import torch


def check_fp32_matmul() -> None:
    """Raise ``RuntimeError`` unless float32 matrix products run in full
    float32: ``allow_tf32`` off and the matmul precision ``"highest"``
    (PyTorch's defaults)."""
    try:
        tf32 = torch.backends.cuda.matmul.allow_tf32
        precision = torch.get_float32_matmul_precision()
    except RuntimeError as exc:
        # torch will not read a mix of its legacy and new TF32 switches
        raise RuntimeError(f"cannot tell whether float32 matmuls run in "
                           f"full float32: {exc}") from exc
    if tf32 or precision != "highest":
        raise RuntimeError(
            f"float32 matmuls may run in reduced precision (allow_tf32="
            f"{tf32}, float32 matmul precision {precision!r}); the sampling "
            "products need full float32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")
