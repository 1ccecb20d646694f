"""Attention dispatch and the plain masked attention (counterpart of the JAX
``ops/attention.py``).

``attention(impl="flash")`` is the flash kernels (``ops/flash_attention``);
``impl="xla"`` is ``xla_attention``, plain masked attention with GQA and an
f32 softmax.

Layout: q [batch, q_len, num_heads, head_dim], k/v [batch, kv_len,
num_kv_heads, head_dim]. Masked scores take a large finite negative rather
than -inf, so a fully masked row softmaxes to a uniform average instead of
NaN, exactly as the JAX version does. That is why this is not
``scaled_dot_product_attention``: prefill chunks must match the JAX masking.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from llm_fine_tune_distributed_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)

_NEG_INF = -2.0e38


def _causal_mask(q_len: int, kv_len: int, device) -> torch.Tensor:
    """[q_len, kv_len] bool, True = attend; the queries are the last q_len
    positions of kv_len."""
    q_pos = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    k_pos = torch.arange(kv_len, device=device)[None, :]
    return k_pos <= q_pos


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    padding_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    causal: bool = True,
    sliding_window: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Reference masked attention. ``padding_mask`` [b, kv_len] (1 = real),
    ``segment_ids`` [b, kv_len] (attend within equal ids), ``mask`` [b, q_len,
    kv_len] bool replaces the causal mask. Returns [b, q_len, hq, d] in q's
    dtype."""
    if sliding_window is not None or logit_softcap is not None:
        raise NotImplementedError(
            "sliding window and logit softcap are not ported "
            "(llm_fine_tune_distributed_tpu.ops.attention.xla_attention has them)"
        )
    b, q_len, num_heads, head_dim = q.shape
    kv_len, num_kv = k.shape[1], k.shape[2]
    groups = num_heads // num_kv
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    qg = q.reshape(b, q_len, num_kv, groups, head_dim).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    neg = torch.full((), _NEG_INF, dtype=torch.float32, device=q.device)  # no host copy
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, neg)
    elif causal:
        cmask = _causal_mask(q_len, kv_len, q.device)
        scores = torch.where(cmask[None, None, None], scores, neg)
    if padding_mask is not None:
        pm = padding_mask.bool()[:, None, None, None, :]
        scores = torch.where(pm, scores, neg)
    if segment_ids is not None:
        same = segment_ids[:, None, :] == segment_ids[:, :, None]  # [b, q, kv]
        scores = torch.where(same[:, None, None], scores, neg)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, q_len, num_heads, head_dim).to(q.dtype)


def _dispatch(q, k, v, impl, padding_mask, segment_ids, causal, flash_fn):
    if impl == "flash":
        if not causal:
            raise ValueError("the flash kernels are causal only; use impl='xla'")
        return flash_fn(q, k, v, padding_mask=padding_mask, segment_ids=segment_ids)
    if impl == "xla":
        return xla_attention(q, k, v, padding_mask=padding_mask, segment_ids=segment_ids,
                             causal=causal)
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention_impl={impl!r} (sequence parallelism) is not ported "
            "(llm_fine_tune_distributed_tpu.ops.attention.attention has it)"
        )
    raise ValueError(f"unknown attention impl {impl!r}")


def attention(q, k, v, *, impl: str = "xla", padding_mask=None, segment_ids=None,
              causal: bool = True):
    """q [b, s, hq, d], k/v [b, s, hkv, d] -> [b, s, hq, d] in q's dtype.

    ``impl="flash"``: the flash kernels, differentiable; on a CUDA tensor
    every call launches them, or raises naming the constraint that failed
    (there is no quiet fall-back to the plain attention). Pad queries
    (``padding_mask`` 0) attend to the pad keys at or before them, the TPU
    kernel's segment rule. ``impl="xla"``: ``xla_attention``.
    """
    return _dispatch(q, k, v, impl, padding_mask, segment_ids, causal, flash_attention)


def attention_plain(q, k, v, *, impl: str = "xla", padding_mask=None, segment_ids=None,
                    causal: bool = True):
    """``attention`` with the flash kernels' plain versions in their place
    (forward and backward), for comparing a whole model against the
    kernels. Nothing on the training path calls it."""
    return _dispatch(q, k, v, impl, padding_mask, segment_ids, causal, flash_attention_reference)
