"""Device policy for the port.

Entry points run on the card unless the caller asks for the CPU:
`resolve_device(None)` is `cuda`, and a machine without a CUDA device
raises instead of silently falling back.  `device="cpu"` is the
explicit opt-in the CPU tests use.

TF32 is switched off for matmuls and cuDNN: the JAX reference's float32
claims assume full float32 arithmetic, and TF32 keeps about three
decimal digits.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def set_precision_policy() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on.  None means `cuda`; a CUDA
    request on a machine with no CUDA device raises."""
    set_precision_policy()
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
