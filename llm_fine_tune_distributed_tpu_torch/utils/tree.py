"""Helpers over flat parameter dicts keyed by dotted names (counterpart of
the JAX ``utils/tree.py``, whose trees are nested and whose paths use ``/``;
the port keeps its parameters flat, ``model.layers.0.self_attn.q_proj.kernel``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


def split_by_mask(params: Params, mask: Dict[str, bool]) -> Tuple[Params, Params]:
    """(trainable, frozen): the leaves whose mask is True, and the rest.
    Autograd, gradients and optimizer state then touch the trainable subset
    only."""
    trainable = {k: v for k, v in params.items() if mask[k]}
    frozen = {k: v for k, v in params.items() if not mask[k]}
    return trainable, frozen


def merge_flat(trainable: Params, frozen: Params) -> Params:
    """Inverse of ``split_by_mask``: one flat dict of every leaf."""
    return {**trainable, **frozen}


def count_params(params: Params) -> int:
    return sum(t.numel() for t in params.values())


def count_params_where(params: Params, predicate: Callable[[str], bool]) -> int:
    return sum(t.numel() for name, t in params.items() if predicate(name))
