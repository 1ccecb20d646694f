"""Sampling-time logits processing (counterpart of the JAX
``infer/sampling.py``): repetition penalty -> temperature -> top-k -> top-p
-> categorical sample, HF ``model.generate`` semantics.

Randomness comes from an explicit ``torch.Generator`` per request. A
categorical draw is ``argmax(logits + gumbel)``, with the Gumbel noise drawn
from that generator or handed in by the caller, so a test can feed the same
noise to this module and to the JAX one.

Speculative verification (``rejection_sample_step`` and its per-row
``_traced`` twin) accepts a draft token d with probability q(d) under the
warped target distribution q, else draws from q with d removed, so each
emitted token is q-distributed. Its uniform ``u`` and categorical noise are
arguments too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

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
    # speculative decoding: draft this many tokens per step (prompt lookup,
    # or the Generator's draft model) and verify them in one forward; 0 = off
    speculative_lookup: int = 0


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


def uniform_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform [0, 1) f32 draws from ``generator``: speculation's accept test."""
    return torch.rand(shape, generator=generator, device=device, dtype=torch.float32)


def _residual_choice(probs: torch.Tensor, residual: torch.Tensor, gumbel: torch.Tensor):
    """The index of a draw from ``residual`` renormalized (``gumbel`` noise
    of its shape). A zero residual, where q is a point mass at the draft and
    the draft is accepted, falls back to ``probs``."""
    z = residual.sum(dim=-1, keepdim=True)
    residual = torch.where(z > 0, residual / z, probs)
    return torch.argmax(torch.log(residual + 1e-30) + gumbel, dim=-1)


def rejection_sample_step(logits: torch.Tensor, seen: torch.Tensor, draft: torch.Tensor,
                          config: GenerationConfig, *, bonus: bool = False,
                          u: Optional[torch.Tensor] = None, gumbel: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None):
    """One speculative verify position in ``_warp``'s top-k space: accept
    ``draft`` [batch] with probability q(draft), else draw from the
    renormalized residual; with ``bonus`` (the position past the last draft)
    a plain q-sample that is never accepted. A draft outside the top-k/top-p
    support has q = 0 and is always rejected. ``u`` [batch] and ``gumbel``
    [batch, k] are the draws (from ``generator`` when absent, in that
    order). Returns (token [batch] int64, accepted [batch] bool)."""
    vals, idx = _warp(logits, seen, config)
    probs = torch.softmax(vals, dim=-1)
    match = idx == draft[:, None]
    q_d = (probs * match).sum(dim=-1)
    if u is None:
        u = uniform_noise(q_d.shape, generator, q_d.device)
    if gumbel is None:
        gumbel = gumbel_noise(vals.shape, generator, vals.device)
    accept = (u < q_d) & (not bonus)
    residual = probs if bonus else torch.where(match, 0.0, probs)
    alt = torch.gather(idx, 1, _residual_choice(probs, residual, gumbel)[:, None])[:, 0]
    return torch.where(accept, draft.long(), alt), accept


def greedy_verify(logits: torch.Tensor, seen: torch.Tensor, draft: torch.Tensor,
                  repetition_penalty: torch.Tensor, bonus: torch.Tensor):
    """The greedy rows of ``rejection_sample_step_traced``: (the argmax of
    the penalized logits [batch], whether the draft equals it and ``bonus``
    is off [batch], the penalized logits [batch, vocab])."""
    pen = repetition_penalty[:, None]
    penalized = torch.where(seen, torch.where(logits > 0, logits / pen, logits * pen), logits)
    greedy = torch.argmax(penalized, dim=-1)
    return greedy, (draft == greedy) & ~bonus, penalized


def rejection_sample_step_traced(logits: torch.Tensor, seen: torch.Tensor, draft: torch.Tensor, *,
                                 temperature: torch.Tensor, top_p: torch.Tensor,
                                 top_k: torch.Tensor, repetition_penalty: torch.Tensor,
                                 do_sample: torch.Tensor, bonus: torch.Tensor,
                                 u: Optional[torch.Tensor] = None,
                                 gumbel: Optional[torch.Tensor] = None,
                                 generators: Optional[Sequence[Optional[torch.Generator]]] = None):
    """``rejection_sample_step`` with per-row knobs: one verify position of
    the engines' fused speculative tick, each row with its own config and
    draft. The warp runs over a full descending sort (penalty ->
    temperature -> top-k rank mask -> top-p), as the JAX traced step does.

    Greedy rows emit ``argmax(penalized)``, bitwise the plain step's token;
    their draft counts as accepted when it equals that token and ``bonus``
    is off (``greedy_verify``, which a batch without sampled rows calls
    alone, skipping the sort). Sampled rows accept their draft with
    probability q(draft), else draw the residual.

    Knobs are [batch] tensors: ``temperature``, ``top_p`` and
    ``repetition_penalty`` f32, ``top_k`` int (vocab = disabled),
    ``do_sample`` and ``bonus`` bool. ``u`` [batch] and ``gumbel`` [batch,
    vocab] are the draws; when absent, each row with a generator in
    ``generators`` draws one uniform and then one [vocab] noise row from it.
    Returns (token [batch] int64, accepted [batch] bool)."""
    greedy, accept_greedy, penalized = greedy_verify(logits, seen, draft, repetition_penalty,
                                                     bonus)
    b, vocab = logits.shape
    scaled = penalized / temperature.clamp(min=1e-6)[:, None]
    order = torch.argsort(-scaled, dim=-1, stable=True)
    vals = torch.gather(scaled, 1, order)
    rank = torch.arange(vocab, device=logits.device)[None, :]
    vals = torch.where(rank < top_k[:, None], vals, _NEG_INF)
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]
    keep[:, 0] = True  # the most probable token always survives, as in _warp
    probs = torch.softmax(torch.where(keep, vals, _NEG_INF), dim=-1)
    match = order == draft[:, None]
    q_d = (probs * match).sum(dim=-1)
    if u is None or gumbel is None:
        u = torch.zeros(b, dtype=torch.float32, device=logits.device)
        gumbel = torch.zeros(b, vocab, dtype=torch.float32, device=logits.device)
        for row, g in enumerate(generators):
            if g is not None:
                u[row] = uniform_noise((), g, logits.device)
                gumbel[row] = gumbel_noise((vocab,), g, logits.device)
    accept_sampled = (u < q_d) & ~bonus
    residual = torch.where(bonus[:, None], probs, torch.where(match, 0.0, probs))
    alt = torch.gather(order, 1, _residual_choice(probs, residual, gumbel)[:, None])[:, 0]
    sampled = torch.where(accept_sampled, draft.long(), alt)
    return (torch.where(do_sample, sampled, greedy),
            torch.where(do_sample, accept_sampled, accept_greedy))
