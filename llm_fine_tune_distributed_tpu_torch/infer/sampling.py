"""Sampling-time logits processing (counterpart of the JAX
``infer/sampling.py``): repetition penalty -> temperature -> top-k -> top-p
-> categorical sample, HF ``model.generate`` semantics.

Randomness comes from an explicit ``torch.Generator`` per request. A
categorical draw is ``argmax(logits + gumbel)``, with the Gumbel noise drawn
from that generator or handed in by the caller, so a test can feed the same
noise to this module and to the JAX one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

_NEG_INF = -1.0e30


@dataclass(frozen=True)
class GenerationConfig:
    """Defaults are the reference's tuned-model sampling parameters."""

    max_new_tokens: int = 3768
    do_sample: bool = True
    temperature: float = 0.6
    top_p: float = 0.95
    top_k: Optional[int] = 40
    repetition_penalty: float = 1.1
    speculative_lookup: int = 0  # not ported: must stay 0


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor, penalty) -> torch.Tensor:
    """HF semantics: logits of tokens already in the sequence are divided by
    the penalty when positive and multiplied by it when negative."""
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def _warp(logits: torch.Tensor, seen: torch.Tensor, config: GenerationConfig):
    """logits/seen [batch, vocab] -> (vals [batch, k], idx [batch, k]) in
    descending order, entries cut by top-p at ``_NEG_INF``."""
    if config.repetition_penalty != 1.0:
        logits = apply_repetition_penalty(logits, seen, config.repetition_penalty)
    logits = logits / max(config.temperature, 1e-6)
    vocab = logits.shape[-1]
    k = min(config.top_k or vocab, vocab)
    vals, idx = torch.topk(logits, k, dim=-1)
    if config.top_p < 1.0:
        probs = torch.softmax(vals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < config.top_p
        keep[..., 0] = True  # the most probable token always survives
        vals = torch.where(keep, vals, torch.full_like(vals, _NEG_INF))
    return vals, idx


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - 2**-24)))


def sample_token(logits: torch.Tensor, seen: torch.Tensor, config: GenerationConfig, *,
                 gumbel: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits/seen [batch, vocab] -> tokens [batch] int64. Greedy is the
    argmax of the penalized logits; sampling draws from ``_warp``'s
    distribution with ``gumbel`` noise [batch, k] (or noise from
    ``generator``)."""
    if not config.do_sample:
        if config.repetition_penalty != 1.0:
            logits = apply_repetition_penalty(logits, seen, config.repetition_penalty)
        return torch.argmax(logits, dim=-1)
    vals, idx = _warp(logits, seen, config)
    if gumbel is None:
        gumbel = gumbel_noise(vals.shape, generator, vals.device)
    choice = torch.argmax(vals + gumbel, dim=-1)
    return torch.gather(idx, 1, choice[:, None])[:, 0]
