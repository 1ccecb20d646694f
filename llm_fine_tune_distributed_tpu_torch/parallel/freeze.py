"""Partial-layer freezing policy (counterpart of the JAX
``parallel/freeze.py``).

``last_n_and_head``: only the last ``unfreeze_last_n_layers`` transformer
layers and the lm_head train. With tied embeddings the lm_head IS the
embedding matrix, so it trains too, and its gradient through the input lookup
flows back through every layer, except through a frozen trunk run in int8
(``frozen_trunk_boundary``, ``quantize_trunk_int8``). ``lora`` and
``qlora``: only the adapters' ``lora_a`` / ``lora_b`` train (their scale and
every base leaf stay frozen; ``qlora`` then stores the frozen block linears
in NF4, ``parallel/qlora.py``). ``none``: everything trains.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Tuple

from llm_fine_tune_distributed_tpu_torch.config import TrainConfig
from llm_fine_tune_distributed_tpu_torch.models.configs import ModelConfig
from llm_fine_tune_distributed_tpu_torch.ops.int8 import quantize_int8
from llm_fine_tune_distributed_tpu_torch.ops.int8_matmul import kmajor
from llm_fine_tune_distributed_tpu_torch.utils.tree import Params, count_params, count_params_where

_LAYER_RE = re.compile(r"model\.layers\.(\d+)\.")


def trainable_predicate(config: ModelConfig, train: TrainConfig) -> Callable[[str], bool]:
    strategy = train.freeze_strategy
    if strategy == "none":
        return lambda name: True
    if strategy in ("lora", "qlora"):
        return lambda name: name.endswith((".lora_a", ".lora_b"))
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


def frozen_trunk_boundary(mask: Dict[str, bool], num_layers: int) -> int:
    """Number of leading entirely frozen transformer layers (the trunk): the
    earliest layer with any trainable leaf. Layers ``[0, boundary)`` run the
    int8 fast path under ``frozen_compute="int8"``; 0 means no trunk
    (``none``: full fine-tuning). ``last_n_and_head`` gives ``num_layers -
    unfreeze_last_n_layers``. A trainable leaf outside the layers (the tied
    embedding) does not shrink the trunk: its gradient through the trunk's
    input lookup is dropped, as in the JAX package."""
    boundary = num_layers
    for name, trainable in mask.items():
        m = _LAYER_RE.search(name) if trainable else None
        if m:
            boundary = min(boundary, int(m.group(1)))
    return boundary


def quantize_trunk_int8(frozen: Params, boundary: int) -> Tuple[Params, int]:
    """Replace each 2-D ``...kernel`` of layers ``[0, boundary)`` with its
    int8 siblings ``...kernel_int8`` and ``...kernel_int8_scale``
    (``ops/int8.quantize_int8``); norms and embeddings pass through. The
    codes keep their ``[in, out]`` shape and values but are K-major in
    memory (``ops/int8_matmul.kmajor``), the layout the w8a8 kernel reads.
    Call it on full-precision leaves, before any cast, so the 8-bit rounding
    is the only one. Returns ``(new_frozen, number of kernels quantized)``."""
    quantized: Params = {}
    n_quant = 0
    for name, v in frozen.items():
        m = _LAYER_RE.search(name)
        if m and int(m.group(1)) < boundary and name.endswith(".kernel") and v.dim() == 2:
            q = quantize_int8(v)
            quantized[f"{name}_int8"] = kmajor(q["int8"])
            quantized[f"{name}_int8_scale"] = q["int8_scale"]
            n_quant += 1
        else:
            quantized[name] = v
    return quantized, n_quant


def describe_trainable(params: Params, mask: Dict[str, bool]) -> dict:
    """The trainable-parameter report of the JAX package."""
    total = count_params(params)
    trainable = count_params_where(params, lambda name: mask[name])
    return {
        "total_parameters": total,
        "trainable_parameters": trainable,
        "trainable_percent": round(100.0 * trainable / total, 2),
    }
