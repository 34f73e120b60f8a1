"""Matmul-precision policy (counterpart of qpalm_tpu/precision.py).

Every float32 product on the solver's path runs in true float32.  The
fused kernel and the general solver are iteration-identical only at full
f32, and the polish preconditioner diverges when its assembly loses bits
(qpalm_tpu/precision.py, polish_device.py).  On an NVIDIA card PyTorch may
route float32 products through TF32 tensor cores, which keep about three
decimal digits; `full_f32_matmul` turns that off.  It is called at the
entry points, never at import.
"""

from __future__ import annotations

import torch


def full_f32_matmul() -> None:
    """Pin float32 matmuls and convolutions to full f32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
