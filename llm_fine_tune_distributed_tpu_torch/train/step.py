"""Loss, train step and eval step (counterpart of the JAX
``train/step.py``).

PyTorch runs eagerly, so the JAX package's one jitted program per optimizer
step becomes a Python loop: for each microbatch of the accumulation axis a
forward and a backward (gradients summed in ``.grad``), then the mean of the
microbatch means, the global norm before clipping, clip and AdamW.

Under data parallelism (a process group; ``runtime/distributed.py``) the
loss is the JAX one: the token mean over the *global* microbatch. Each rank
divides its cross-entropy sum by the global microbatch's token count, which
the trainer counts on the host from the global batch (no collective, no
device sync), so the ranks' losses and gradients sum to the global mean's.
Under ZeRO-3 (``parallel/optimizer.FsdpShards``) the forward gathers each
block's leaves and the backward reduce-scatters each sharded gradient onto
this rank's slice. After the accumulation loop one bucketed all-reduce sums
the whole leaves' gradients and the loss across ranks
(``all_reduce_grads``), and AdamW runs on the reduced gradients (this
rank's slices of the sharded leaves). Without a process group the step
issues no collective.

Under tensor parallelism (``parallel/sharding.TensorShards``) the ranks of
one tensor group read the same rows and hold the same loss: the logits
are each rank's vocab slice, and the cross-entropy is vocab-parallel
(``vocab_parallel_ce``: the max, and the sum of exponentials with the gold
logit, all-reduced over the group; the backward is the local softmax less
the one-hot on the rank that owns the target), so the ``[b, s, vocab]``
logits never exist on one rank. The gradients and the loss are summed over
the ranks of one tensor index (``runtime/mesh.grad_reduction``), never
over the tensor group, which would count the loss tp times; the LoRA
factors' shares are then summed over the tensor group.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from llm_fine_tune_distributed_tpu_torch.config import TrainConfig, str_to_dtype
from llm_fine_tune_distributed_tpu_torch.models.configs import ModelConfig
from llm_fine_tune_distributed_tpu_torch.models.transformer import forward
from llm_fine_tune_distributed_tpu_torch.ops.attention import attention
from llm_fine_tune_distributed_tpu_torch.ops.int8_matmul import int8_w8a8_matmul
from llm_fine_tune_distributed_tpu_torch.parallel.optimizer import AdamW, FsdpShards
from llm_fine_tune_distributed_tpu_torch.runtime.distributed import (
    all_reduce_grads,
    all_reduce_max_,
    tensor_collectives,
)
from llm_fine_tune_distributed_tpu_torch.train.state import TrainState
from llm_fine_tune_distributed_tpu_torch.utils.tree import merge_flat

_JAX_LOSS = "llm_fine_tune_distributed_tpu.train.step.make_loss_fn"


class _VocabParallelCE(torch.autograd.Function):
    """Cross-entropy of ``logits [N, V / tp]`` (this rank's vocab slice,
    starting at ``start``) against global ``targets [N]``: the row max
    (a max all-reduce), then the sum of exponentials and the gold logit (one
    sum all-reduce of both) over the tensor group. The backward is the
    local softmax less the one-hot where this rank owns the target, each
    row scaled by its gradient: no collective."""

    @staticmethod
    def forward(ctx, logits, targets, start, group):
        m = logits.detach().amax(dim=-1)
        tensor_collectives.forward += 2
        all_reduce_max_(m, group)
        vl = logits.shape[1]
        local = targets - start
        mine = (local >= 0) & (local < vl)
        local = local.clamp(0, vl - 1)
        gold = torch.where(mine, logits.gather(1, local[:, None])[:, 0] - m, 0.0)
        e = (logits - m[:, None]).exp_()
        both = torch.stack([e.sum(dim=-1), gold])
        dist.all_reduce(both, group=group)
        e.div_(both[0][:, None])  # the softmax, kept for the backward
        ctx.save_for_backward(e, local, mine)
        return torch.log(both[0]) - both[1]

    @staticmethod
    def backward(ctx, dce):
        p, local, mine = ctx.saved_tensors
        grad = p * dce[:, None]
        grad.scatter_add_(1, local[:, None], torch.where(mine, -dce, 0.0)[:, None])
        return grad, None, None, None


def vocab_parallel_ce(logits: torch.Tensor, targets: torch.Tensor, tensor) -> torch.Tensor:
    """Per-position cross-entropy ``[...]`` from this rank's vocab slice of
    the logits ``[..., V / tp]`` (f32) and the global ``targets [...]``,
    over ``tensor``'s group (``_VocabParallelCE``)."""
    vl = logits.shape[-1]
    ce = _VocabParallelCE.apply(logits.reshape(-1, vl), targets.reshape(-1).long(),
                                tensor.index * vl, tensor.group)
    return ce.reshape(targets.shape)


def make_loss_fn(model_config: ModelConfig, train_config: TrainConfig, *,
                 attention_fn=attention, frozen_layers: int = 0,
                 trunk_matmul=int8_w8a8_matmul, shards: Optional[FsdpShards] = None,
                 tensor=None) -> Callable:
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
    which go to the forward. ``shards`` (ZeRO-3): the leaves are this
    rank's slices, gathered by the forward block by block. ``tensor``
    (``TensorShards``): the leaves are this rank's tensor slices, and the
    cross-entropy is ``vocab_parallel_ce`` over its vocab slice."""
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

    def loss_fn(trainable, frozen, batch, tokens=None):
        """``tokens``: the denominator of the token mean (the global
        microbatch's count under data parallelism); None: this batch's."""
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
            gather=shards.gather if shards is not None else None,
            tensor=tensor,
        )
        b, s, vocab = logits.shape
        # CE of every position against the next token; the last position's
        # target is a dummy 0 and its mask is 0, so the [b, s, vocab] logits
        # are read in place, never copied to drop their last column
        targets = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], dim=1).long()
        if tensor is not None:
            ce = vocab_parallel_ce(logits, targets, tensor)[:, :-1]
        else:
            ce = F.cross_entropy(logits.reshape(b * s, vocab), targets.reshape(-1),
                                 reduction="none").reshape(b, s)[:, :-1]
        mask = batch["loss_mask"][:, 1:].float()
        if tokens is None:
            tokens = mask.sum().clamp_min(1.0)
        loss = (ce * mask).sum() / tokens
        if "completion_mask" in batch:
            amask = batch["completion_mask"][:, 1:].float()
            return loss, tokens, (ce * amask).sum(), amask.sum()
        return loss, tokens

    return loss_fn


def reduced_step(params: Dict[str, torch.Tensor], state: TrainState, optimizer: AdamW,
                 accum: int, scalars: torch.Tensor, shards: Optional[FsdpShards] = None,
                 tensor=None, reduction=(True, None)):
    """The end of a step, after the accumulation loop: the gradients (and
    ``scalars``, the loop's summed loss and aux, f32) summed across ranks by
    one bucketed all-reduce, the mean over the microbatches, AdamW. Returns
    (grad_norm, the summed ``scalars``). Under ``shards`` a sharded leaf's
    gradient is its slice, already summed over the fsdp group by the
    backward's reduce-scatter: only a data axis beside fsdp sums it again,
    over the replica group. ``reduction`` is ``runtime/mesh.grad_reduction``
    (whether, and over which group, the rest is summed); under ``tensor``
    the LoRA factors' shares are summed over the tensor group too."""
    sharded = shards.dims if shards is not None else {}
    do, group = reduction
    if do:
        scalars = all_reduce_grads([p.grad for k, p in params.items() if k not in sharded],
                                   scalars, group=group)
    if shards is not None and shards.replica_group is not None:
        all_reduce_grads([p.grad for k, p in params.items() if k in sharded], scalars.new_zeros(0),
                         group=shards.replica_group)
    if tensor is not None:
        partial = [p.grad for k, p in params.items() if tensor.partial(k)]
        if partial:
            all_reduce_grads(partial, scalars.new_zeros(0), group=tensor.group)
    # mean over accumulation steps (HF: the mean of the microbatch means)
    grads = {k: p.grad / accum for k, p in params.items()}
    for p in params.values():
        p.grad = None
    kw = {"tensor": tensor} if tensor is not None else {}
    grad_norm = optimizer.step(params, grads, state.opt_state, shards, **kw)
    state.step += 1
    return grad_norm, scalars


def build_train_step(model_config: ModelConfig, train_config: TrainConfig,
                     optimizer: AdamW, frozen_layers: int = 0,
                     shards: Optional[FsdpShards] = None, tensor=None,
                     reduction=(True, None)) -> Callable:
    """train_step(state, batch, tokens=None) -> (state, {"loss",
    "grad_norm"}), batch arrays ``[grad_accum, batch, seq]`` on the device;
    ``tokens`` (``[grad_accum]`` floats, under data parallelism) the global
    microbatches' token counts. Updates the state in place and returns it."""
    loss_fn = make_loss_fn(model_config, train_config, frozen_layers=frozen_layers, shards=shards,
                           tensor=tensor)
    accum = train_config.gradient_accumulation_steps

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], tokens=None):
        params = state.trainable
        for p in params.values():
            p.grad = None
        loss_sum = None
        if tokens is not None:
            # on the device, so each division is tensor by tensor as in the
            # one-process loss (a host scalar divisor is taken as its
            # reciprocal, another rounding)
            tokens = torch.as_tensor(tokens, dtype=torch.float32).to(batch["input_ids"].device)
        for i in range(accum):
            loss, _ = loss_fn(params, state.frozen, {k: v[i] for k, v in batch.items()},
                              None if tokens is None else tokens[i])
            loss.backward()  # sums each leaf's gradient over the microbatches
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        grad_norm, loss_sum = reduced_step(params, state, optimizer, accum,
                                           loss_sum.float().reshape(1), shards, tensor, reduction)
        return state, {"loss": loss_sum[0] / accum, "grad_norm": grad_norm}

    return train_step


def build_eval_step(model_config: ModelConfig, train_config: TrainConfig,
                    frozen_layers: int = 0, shards: Optional[FsdpShards] = None,
                    tensor=None) -> Callable:
    """eval_step(state, batch [b, s]) -> (ce_sum, tokens) or (ce_sum,
    tokens, answer_ce_sum, answer_tokens): sums, so the caller weighs the
    eval loss by tokens over the whole validation set. ``tokens`` is the
    batch's count as it is (0 for a batch of pad rows); the loss's floor of
    one token per batch is the caller's to add, per global batch."""
    loss_fn = make_loss_fn(model_config, train_config, frozen_layers=frozen_layers, shards=shards,
                           tensor=tensor)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        out = loss_fn(state.trainable, state.frozen, batch)
        loss, tokens = out[0], out[1]
        return (loss * tokens, batch["loss_mask"][:, 1:].float().sum(), *out[2:])

    return eval_step
