"""The device an entry point of the port runs on."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; "cuda" without a card raises.

    On CUDA, TF32 is turned off for convolutions and matrix products:
    the reference computes in full float32, and TF32 keeps only about
    three digits. bf16 products also accumulate in float32 throughout
    (no reduced-precision split-K reduction), as XLA's do.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: repro_torch runs on the GPU "
                               "unless the caller passes device='cpu'")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
