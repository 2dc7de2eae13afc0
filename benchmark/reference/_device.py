"""Frozen copy of `kissmpc_tpu_torch/_device.py` at commit d587314.

Part of the benchmark's plain reference: it imports nothing of the port,
of the JAX package or of JAX, so later changes to the port leave the
yardstick where it is.
"""

from __future__ import annotations

import torch


def pin_full_f32() -> None:
    """Disable TF32 for float32 matmuls and convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def constant(values, dtype, device) -> torch.Tensor:
    """A row of Python numbers as a tensor on ``device``, made there by one
    fill per entry: no host value is copied to the card, so the row can be
    made inside a CUDA graph's capture.  Each fill rounds its number to
    ``dtype`` as ``torch.tensor(values, dtype=dtype)`` does; a finite number
    beyond the dtype's range raises where that gives inf."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU explicitly"
            )
        pin_full_f32()
    return dev
