"""Rotary position embeddings, HF Llama "rotate_half" convention
(counterpart of the JAX ``ops/rope.py``). Tables and rotation run in f32."""

from __future__ import annotations

import math

import torch


def rope_inv_freq(
    head_dim: int,
    theta: float,
    *,
    scaling_type=None,
    factor: float = 1.0,
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
    original_max_position: int = 8192,
    device=None,
) -> torch.Tensor:
    """Per-frequency inverse wavelengths [head_dim // 2] f32, with the
    "linear" and "llama3" (Llama-3.1 smoothed NTK) context extensions."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))
    if scaling_type in (None, "default"):
        return inv_freq
    if scaling_type == "linear":
        return inv_freq / factor
    if scaling_type == "llama3":
        low_freq_wavelen = original_max_position / low_freq_factor
        high_freq_wavelen = original_max_position / high_freq_factor
        wavelen = 2.0 * math.pi / inv_freq
        scaled = inv_freq / factor
        smooth = (original_max_position / wavelen - low_freq_factor) / (
            high_freq_factor - low_freq_factor
        )
        smoothed = (1.0 - smooth) * scaled + smooth * inv_freq
        out = torch.where(wavelen > low_freq_wavelen, scaled, inv_freq)
        is_medium = (wavelen <= low_freq_wavelen) & (wavelen >= high_freq_wavelen)
        return torch.where(is_medium, smoothed, out)
    raise ValueError(f"unsupported rope scaling type: {scaling_type!r}")


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float, *, config=None):
    """positions [...] int -> (cos, sin) [..., head_dim] f32; ``config``'s
    ``rope_scaling_*`` fields select the context extension."""
    if config is not None and config.rope_scaling_type:
        inv_freq = rope_inv_freq(
            head_dim,
            theta,
            scaling_type=config.rope_scaling_type,
            factor=config.rope_scaling_factor,
            low_freq_factor=config.rope_low_freq_factor,
            high_freq_factor=config.rope_high_freq_factor,
            original_max_position=config.rope_original_max_position,
            device=positions.device,
        )
    else:
        inv_freq = rope_inv_freq(head_dim, theta, device=positions.device)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """q [b, s, hq, d], k [b, s, hkv, d], cos/sin [b, s, d] -> rotated (q, k)
    in their own dtypes."""
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    q32, k32 = q.float(), k.float()
    q_rot = q32 * c + _rotate_half(q32) * s
    k_rot = k32 * c + _rotate_half(k32) * s
    return q_rot.to(q.dtype), k_rot.to(k.dtype)
