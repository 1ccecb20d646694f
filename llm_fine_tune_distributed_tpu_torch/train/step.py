"""Loss, train step and eval step (counterpart of the JAX
``train/step.py``).

PyTorch runs eagerly, so the JAX package's one jitted program per optimizer
step becomes a Python loop: for each microbatch of the accumulation axis a
forward and a backward (gradients summed in ``.grad``), then the mean of the
microbatch means, the global norm before clipping, clip and AdamW.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from llm_fine_tune_distributed_tpu_torch.config import TrainConfig, str_to_dtype
from llm_fine_tune_distributed_tpu_torch.models.configs import ModelConfig
from llm_fine_tune_distributed_tpu_torch.models.transformer import forward
from llm_fine_tune_distributed_tpu_torch.ops.attention import attention
from llm_fine_tune_distributed_tpu_torch.ops.int8_matmul import int8_w8a8_matmul
from llm_fine_tune_distributed_tpu_torch.parallel.optimizer import AdamW
from llm_fine_tune_distributed_tpu_torch.train.state import TrainState
from llm_fine_tune_distributed_tpu_torch.utils.tree import merge_flat

_JAX_LOSS = "llm_fine_tune_distributed_tpu.train.step.make_loss_fn"


def make_loss_fn(model_config: ModelConfig, train_config: TrainConfig, *,
                 attention_fn=attention, frozen_layers: int = 0,
                 trunk_matmul=int8_w8a8_matmul) -> Callable:
    """loss_fn(trainable, frozen, batch) -> (loss, tokens), or (loss,
    tokens, answer_ce_sum, answer_tokens) when the batch carries a
    ``completion_mask``: masked next-token cross-entropy, the token mean
    over the batch, from the full f32 logits. ``attention_fn`` and
    ``trunk_matmul`` are the attention and the trunk's w8a8 matmul the model
    calls (the kernels' wrappers unless a caller passes plain ones for a
    comparison). ``frozen_layers`` is the trunk boundary
    (``parallel/freeze.frozen_trunk_boundary``); with
    ``frozen_compute="int8"`` those layers run the frozen trunk. A packed
    batch (``packing=True``) also carries ``segment_ids`` and ``positions``,
    which go to the forward."""
    if train_config.loss_chunk_size is not None or train_config.loss_vocab_chunk is not None:
        raise NotImplementedError(
            f"loss_chunk_size / loss_vocab_chunk (chunked cross-entropy) are not ported "
            f"({_JAX_LOSS} has them)"
        )
    if train_config.frozen_compute not in ("bf16", "int8"):
        raise ValueError(
            f"unknown frozen_compute {train_config.frozen_compute!r} (expected 'bf16' or 'int8')"
        )
    compute_dtype = str_to_dtype(train_config.compute_dtype)
    remat_policy = train_config.resolved_remat_policy(model_config)

    def loss_fn(trainable, frozen, batch):
        params = merge_flat(trainable, frozen)
        ids = batch["input_ids"]
        logits, _ = forward(
            params, ids, model_config,
            positions=batch.get("positions"),
            padding_mask=batch["attention_mask"],
            segment_ids=batch.get("segment_ids"),
            attention_impl=train_config.attention_impl,
            compute_dtype=compute_dtype,
            remat=train_config.gradient_checkpointing,
            remat_policy=remat_policy,
            logits_dtype=torch.float32,
            attention_fn=attention_fn,
            frozen_layers=frozen_layers,
            frozen_compute=train_config.frozen_compute,
            trunk_matmul=trunk_matmul,
        )
        b, s, vocab = logits.shape
        # CE of every position against the next token; the last position's
        # target is a dummy 0 and its mask is 0, so the [b, s, vocab] logits
        # are read in place, never copied to drop their last column
        targets = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], dim=1).long()
        ce = F.cross_entropy(logits.reshape(b * s, vocab), targets.reshape(-1),
                             reduction="none").reshape(b, s)[:, :-1]
        mask = batch["loss_mask"][:, 1:].float()
        tokens = mask.sum().clamp_min(1.0)
        loss = (ce * mask).sum() / tokens
        if "completion_mask" in batch:
            amask = batch["completion_mask"][:, 1:].float()
            return loss, tokens, (ce * amask).sum(), amask.sum()
        return loss, tokens

    return loss_fn


def build_train_step(model_config: ModelConfig, train_config: TrainConfig,
                     optimizer: AdamW, frozen_layers: int = 0) -> Callable:
    """train_step(state, batch) -> (state, {"loss", "grad_norm"}), batch
    arrays ``[grad_accum, batch, seq]`` on the device. Updates the state in
    place and returns it."""
    loss_fn = make_loss_fn(model_config, train_config, frozen_layers=frozen_layers)
    accum = train_config.gradient_accumulation_steps

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.trainable
        for p in params.values():
            p.grad = None
        loss_sum = None
        for i in range(accum):
            loss, _ = loss_fn(params, state.frozen, {k: v[i] for k, v in batch.items()})
            loss.backward()  # sums each leaf's gradient over the microbatches
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        # mean over accumulation steps (HF: the mean of the microbatch means)
        grads = {k: p.grad / accum for k, p in params.items()}
        for p in params.values():
            p.grad = None
        grad_norm = optimizer.step(params, grads, state.opt_state)
        state.step += 1
        return state, {"loss": loss_sum / accum, "grad_norm": grad_norm}

    return train_step


def build_eval_step(model_config: ModelConfig, train_config: TrainConfig,
                    frozen_layers: int = 0) -> Callable:
    """eval_step(state, batch [b, s]) -> (ce_sum, tokens) or (ce_sum,
    tokens, answer_ce_sum, answer_tokens): sums, so the caller weighs the
    eval loss by tokens over the whole validation set."""
    loss_fn = make_loss_fn(model_config, train_config, frozen_layers=frozen_layers)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        out = loss_fn(state.trainable, state.frozen, batch)
        loss, tokens = out[0], out[1]
        return (loss * tokens, tokens, *out[2:])

    return eval_step
