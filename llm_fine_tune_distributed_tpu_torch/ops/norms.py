"""RMSNorm with float32 statistics (counterpart of the JAX ``ops/norms.py``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    """x [..., hidden], weight [hidden] -> x's dtype. The statistics and the
    weight multiply run in f32 and the result is cast once at the end, as in
    the JAX version. ``zero_centered`` (Gemma's ``1 + w``) is not ported."""
    if zero_centered:
        raise NotImplementedError(
            "zero-centered RMSNorm is not ported (llm_fine_tune_distributed_tpu"
            ".ops.norms.rms_norm has it)"
        )
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)
