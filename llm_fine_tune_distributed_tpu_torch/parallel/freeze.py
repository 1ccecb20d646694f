"""Partial-layer freezing policy (counterpart of the JAX
``parallel/freeze.py``).

``last_n_and_head``: only the last ``unfreeze_last_n_layers`` transformer
layers and the lm_head train. With tied embeddings the lm_head IS the
embedding matrix, so it trains too, and its gradient through the input lookup
flows back through every layer.
"""

from __future__ import annotations

import re
from typing import Callable, Dict

from llm_fine_tune_distributed_tpu_torch.config import TrainConfig
from llm_fine_tune_distributed_tpu_torch.models.configs import ModelConfig
from llm_fine_tune_distributed_tpu_torch.utils.tree import Params, count_params, count_params_where

_LAYER_RE = re.compile(r"model\.layers\.(\d+)\.")


def trainable_predicate(config: ModelConfig, train: TrainConfig) -> Callable[[str], bool]:
    strategy = train.freeze_strategy
    if strategy == "none":
        return lambda name: True
    if strategy in ("lora", "qlora"):
        raise NotImplementedError(
            f"freeze_strategy={strategy!r} is not ported "
            "(llm_fine_tune_distributed_tpu.parallel.freeze.trainable_predicate has it)"
        )
    if strategy == "last_n_and_head":
        cutoff = config.num_layers - train.unfreeze_last_n_layers

        def pred(name: str) -> bool:
            m = _LAYER_RE.search(name)
            if m:
                return int(m.group(1)) >= cutoff
            if "lm_head" in name:
                return True
            if config.tie_word_embeddings and "embed_tokens" in name:
                return True  # tied: the lm_head is the embedding matrix
            return False  # final norm and untied embeddings stay frozen

        return pred
    raise ValueError(f"unknown freeze_strategy {strategy!r}")


def trainable_mask(params: Params, config: ModelConfig, train: TrainConfig) -> Dict[str, bool]:
    """{name: True if trainable}."""
    pred = trainable_predicate(config, train)
    return {name: pred(name) for name in params}


def describe_trainable(params: Params, mask: Dict[str, bool]) -> dict:
    """The trainable-parameter report of the JAX package."""
    total = count_params(params)
    trainable = count_params_where(params, lambda name: mask[name])
    return {
        "total_parameters": total,
        "trainable_parameters": trainable,
        "trainable_percent": round(100.0 * trainable / total, 2),
    }
