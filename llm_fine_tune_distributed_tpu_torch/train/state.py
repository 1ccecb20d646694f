"""Training state (counterpart of the JAX ``train/state.py``): trainable and
frozen parameters are separate flat dicts, so gradients and optimizer state
touch the trainable subset only."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch


@dataclass
class TrainState:
    step: int                            # optimizer updates so far
    trainable: Dict[str, torch.Tensor]   # f32 masters, requires_grad
    frozen: Dict[str, torch.Tensor]      # compute dtype, no grad
    opt_state: dict                      # over ``trainable`` only
