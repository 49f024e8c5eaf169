"""Device resolution for the port's entry points.

Every entry point takes ``device=None``: that means the CUDA card, and
raises when no card is present. Nothing falls back to the CPU quietly;
CPU runs (the tests) pass ``device="cpu"`` explicitly.

Importing this module switches TF32 off for float32 matrix products
and convolutions: the JAX package runs every contraction at
``Precision.HIGHEST``, and TF32 keeps only about three decimal digits.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); else the given device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU explicitly"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def host_to_device(a, device: Union[str, torch.device]) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) on ``device``. For a card:
    copied into pinned memory (an already pinned tensor is used as it is)
    and then to the card by a non-blocking copy on the current stream;
    PyTorch's caching host allocator records an event for that copy and
    hands the pinned block out again only once the copy is done. On the
    CPU: ``torch.as_tensor``, sharing the array's memory."""
    host = torch.as_tensor(a)
    if torch.device(device).type != "cuda":
        return host
    if not host.is_pinned():
        host = host.contiguous().pin_memory()
    return host.to(device, non_blocking=True)
