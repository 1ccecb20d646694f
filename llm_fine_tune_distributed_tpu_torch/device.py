"""Device selection shared by every entry point of the port.

Entry points run on the GPU unless the caller asks for the CPU. Without a
GPU they raise instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None``/``"cuda"`` -> the current CUDA device, raising when there is
    none; ``"cpu"`` -> the CPU (tests and the plain kernel versions)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this entry point runs on an NVIDIA GPU and none "
            "is visible to torch (torch.cuda.is_available() is False); pass "
            "device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: expected cuda or cpu")
    return dev

