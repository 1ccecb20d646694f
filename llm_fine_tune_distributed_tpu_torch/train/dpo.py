"""Direct Preference Optimization (counterpart of the JAX ``train/dpo.py``):
the sigmoid DPO loss of TRL's ``DPOTrainer`` (``loss_type="sigmoid"``), with
optional label smoothing.

- One forward for both completions: chosen and rejected rows are
  concatenated along the batch axis, ``[2B, S]``, through the policy, and
  again through the reference.
- The reference is a bf16 copy of the trainable leaves at init, sharing
  every frozen leaf with the policy (with LoRA, B = 0, so it is the base
  model). It runs under ``torch.no_grad``, without rematerialization, and
  is not checkpointed: a resume rebuilds it from the same init.
- ``loss_chunk_size`` unembeds that many positions at a time under
  ``torch.utils.checkpoint``, so the ``[2B, S, vocab]`` f32 logits never
  exist at once; ``loss_vocab_chunk`` is refused, as in the JAX package.
- Accumulation is the SFT step's Python loop (``train/step.py``).

Not here: the pipeline builders (``make_pipeline_dpo_loss_fn`` and its
train and eval steps), which wait for pipeline parallelism.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from llm_fine_tune_distributed_tpu_torch.config import TrainConfig, str_to_dtype
from llm_fine_tune_distributed_tpu_torch.data.dataset import train_validation_split
from llm_fine_tune_distributed_tpu_torch.data.loader import SFTBatchLoader
from llm_fine_tune_distributed_tpu_torch.data.preference import (
    build_dpo_arrays,
    load_rows,
    preference_schema,
    synthesize_preference_rows,
)
from llm_fine_tune_distributed_tpu_torch.models.configs import ModelConfig
from llm_fine_tune_distributed_tpu_torch.models.transformer import forward, unembed
from llm_fine_tune_distributed_tpu_torch.ops.attention import attention
from llm_fine_tune_distributed_tpu_torch.parallel.optimizer import AdamW
from llm_fine_tune_distributed_tpu_torch.train.state import TrainState
from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer
from llm_fine_tune_distributed_tpu_torch.utils.tree import merge_flat

AUX_KEYS = ("rewards_chosen", "rewards_rejected", "rewards_margin", "rewards_accuracy")


def masked_sequence_logprob(per_token_logprob: torch.Tensor, loss_mask: torch.Tensor) -> torch.Tensor:
    """Sum of the target-token logprobs [b, s-1] over the completion
    positions of ``loss_mask`` [b, s] (mask[t] gates predicting token t):
    [b] f32."""
    return (per_token_logprob * loss_mask[:, 1:]).sum(dim=-1)


def _target_logprobs(params, hidden, targets, model_config: ModelConfig, chunk, compute_dtype):
    """Logprob [b, s-1] f32 of ``targets`` [b, s-1] given the final hidden
    states [b, s-1, h]. With ``chunk``, the sequence is unembedded ``chunk``
    positions at a time, each chunk recomputed in the backward, so one
    [b, chunk, vocab] tile of logits lives at a time."""
    def logprobs(h, t):
        logits = unembed(params, h, model_config, compute_dtype=compute_dtype)
        return -F.cross_entropy(logits.reshape(-1, logits.shape[-1]), t.reshape(-1),
                                reduction="none").reshape(t.shape)

    if chunk is None:
        return logprobs(hidden, targets)
    s = hidden.shape[1]
    out = []
    for lo in range(0, s, chunk):
        h, t = hidden[:, lo: lo + chunk], targets[:, lo: lo + chunk]
        if torch.is_grad_enabled():
            out.append(torch_checkpoint.checkpoint(logprobs, h, t, use_reentrant=False,
                                                   preserve_rng_state=False))
        else:
            out.append(logprobs(h, t))
    return torch.cat(out, dim=1)


def _dpo_pair_loss(pi_c, pi_r, ref_c, ref_r, beta: float, eps: float):
    """The sigmoid DPO loss and the reward aux from the chosen and rejected
    sequence logprobs:

      margin = (pi_c - pi_r) - (ref_c - ref_r)
      loss   = -(1 - eps) log sigma(beta margin) - eps log sigma(-beta margin)
    """
    margin = (pi_c - pi_r) - (ref_c - ref_r)
    rewards_chosen = beta * (pi_c - ref_c)
    rewards_rejected = beta * (pi_r - ref_r)
    per_pair_loss = (-(1.0 - eps) * F.logsigmoid(beta * margin)
                     - eps * F.logsigmoid(-beta * margin))
    correct = (rewards_chosen > rewards_rejected).float()
    aux = {
        "rewards_chosen": rewards_chosen.mean(),
        "rewards_rejected": rewards_rejected.mean(),
        "rewards_margin": (rewards_chosen - rewards_rejected).mean(),
        "rewards_accuracy": correct.mean(),
        # per pair, for the pad-aware eval sums
        "per_pair_loss": per_pair_loss,
        "per_pair_correct": correct,
    }
    return per_pair_loss.mean(), aux


def make_dpo_loss_fn(model_config: ModelConfig, train_config: TrainConfig, *,
                     attention_fn=attention) -> Callable:
    """loss_fn(trainable, ref_trainable, frozen, batch) -> (loss, aux): the
    policy's forward over ``[chosen; rejected]`` with gradients, the
    reference's under ``no_grad``. ``attention_fn`` is the flash kernels'
    wrapper unless a caller passes the plain version for a comparison."""
    if train_config.loss_vocab_chunk is not None:
        # DPO streams its logprobs by sequence (loss_chunk_size)
        raise ValueError("loss_vocab_chunk is not supported for objective='dpo'; use "
                         "loss_chunk_size")
    compute_dtype = str_to_dtype(train_config.compute_dtype)
    remat_policy = train_config.resolved_remat_policy(model_config)
    chunk = train_config.loss_chunk_size
    beta, eps = train_config.dpo_beta, train_config.dpo_label_smoothing

    def batch_logprobs(params, ids, attn, mask):
        hidden, _ = forward(
            params, ids, model_config,
            padding_mask=attn,
            attention_impl=train_config.attention_impl,
            compute_dtype=compute_dtype,
            remat=train_config.gradient_checkpointing,
            remat_policy=remat_policy,
            output_hidden=True,
            attention_fn=attention_fn,
        )
        per_token = _target_logprobs(params, hidden[:, :-1], ids[:, 1:].long(), model_config,
                                     chunk, compute_dtype)
        return masked_sequence_logprob(per_token, mask)

    def loss_fn(trainable, ref_trainable, frozen, batch):
        # rows 0..B-1 chosen, B..2B-1 rejected
        ids = torch.cat([batch["chosen_input_ids"], batch["rejected_input_ids"]])
        attn = torch.cat([batch["chosen_attention_mask"], batch["rejected_attention_mask"]])
        mask = torch.cat([batch["chosen_loss_mask"], batch["rejected_loss_mask"]]).float()
        b = batch["chosen_input_ids"].shape[0]
        policy_lp = batch_logprobs(merge_flat(trainable, frozen), ids, attn, mask)
        with torch.no_grad():
            ref = {k: v.detach() for k, v in ref_trainable.items()}
            ref_lp = batch_logprobs(merge_flat(ref, frozen), ids, attn, mask)
        return _dpo_pair_loss(policy_lp[:b], policy_lp[b:], ref_lp[:b], ref_lp[b:], beta, eps)

    return loss_fn


def build_dpo_train_step(model_config: ModelConfig, train_config: TrainConfig,
                         optimizer: AdamW) -> Callable:
    """train_step(state, ref_trainable, batch) -> (state, {"loss",
    "grad_norm", "rewards_*"}), batch arrays ``[grad_accum, pairs, seq]``
    on the device; the state is updated in place."""
    loss_fn = make_dpo_loss_fn(model_config, train_config)
    accum = train_config.gradient_accumulation_steps

    def train_step(state: TrainState, ref_trainable, batch: Dict[str, torch.Tensor]):
        params = state.trainable
        for p in params.values():
            p.grad = None
        loss_sum = None
        aux_sum = {k: 0.0 for k in AUX_KEYS}
        for i in range(accum):
            loss, aux = loss_fn(params, ref_trainable, state.frozen,
                                {k: v[i] for k, v in batch.items()})
            loss.backward()  # sums each leaf's gradient over the microbatches
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            aux_sum = {k: aux_sum[k] + aux[k].detach() for k in AUX_KEYS}
        grads = {k: p.grad / accum for k, p in params.items()}
        for p in params.values():
            p.grad = None
        grad_norm = optimizer.step(params, grads, state.opt_state)
        state.step += 1
        return state, {"loss": loss_sum / accum, "grad_norm": grad_norm,
                       **{k: v / accum for k, v in aux_sum.items()}}

    return train_step


def build_dpo_eval_step(model_config: ModelConfig, train_config: TrainConfig) -> Callable:
    """eval_step(state, ref_trainable, batch) -> (loss_sum, acc_sum, n_real)
    over the rows whose ``batch["pair_mask"]`` is 1 (0 = wrap padding)."""
    loss_fn = make_dpo_loss_fn(model_config, train_config)

    @torch.no_grad()
    def eval_step(state: TrainState, ref_trainable, batch: Dict[str, torch.Tensor]):
        batch = dict(batch)
        pair_mask = batch.pop("pair_mask")
        _, aux = loss_fn(state.trainable, ref_trainable, state.frozen, batch)
        return ((aux["per_pair_loss"] * pair_mask).sum(),
                (aux["per_pair_correct"] * pair_mask).sum(), pair_mask.sum())

    return eval_step


class DPOTrainer(SFTTrainer):
    """The SFT trainer (freezing, LoRA/QLoRA, checkpoints, publish,
    artifacts) with the DPO objective: pairs synthesized within each split
    from QA rows (or read as prompt/chosen/rejected), the reference a bf16
    copy of the initial trainable leaves, and ``eval_rewards_accuracy``
    logged with every eval."""

    def _prepare_data(self) -> None:
        cfg = self.config
        path = os.path.join(cfg.data_dir, cfg.dataset_file)
        rows = load_rows(path)
        schema = preference_schema(rows)
        print(f"Total preference dataset size: {len(rows):,} pairs ({schema})")
        train_rows, val_rows = train_validation_split(
            rows, test_size=cfg.validation_fraction, seed=cfg.split_seed)
        if schema == "qa":
            # within each split: a validation pair's rejected text is never a
            # training pair's chosen one
            train_rows = synthesize_preference_rows(train_rows, seed=cfg.seed)
            val_rows = synthesize_preference_rows(val_rows, seed=cfg.seed)
        self.n_train, self.n_val = len(train_rows), len(val_rows)
        prompt_kw = self._prompt_kwargs()
        self.train_arrays = build_dpo_arrays(train_rows, self.tokenizer, cfg.max_seq_length,
                                             **prompt_kw)
        self.val_arrays = build_dpo_arrays(val_rows, self.tokenizer, cfg.max_seq_length,
                                           **prompt_kw)
        self.loader = SFTBatchLoader(
            self.train_arrays, per_device_batch_size=cfg.per_device_batch_size,
            grad_accum_steps=cfg.gradient_accumulation_steps, seed=cfg.seed,
            drop_last=cfg.drop_last,
        )
        self.steps_per_epoch = self.loader.steps_per_epoch
        self.total_steps = self.steps_per_epoch * cfg.epochs

    def _prepare_state(self) -> None:
        super()._prepare_state()
        # the reference: the trainable leaves at init in the compute dtype
        compute_dtype = str_to_dtype(self.config.compute_dtype)
        self.ref_trainable = {k: v.detach().to(compute_dtype).clone()
                              for k, v in self.state.trainable.items()}

    def _prepare_steps(self) -> None:
        step = build_dpo_train_step(self.model_config, self.config, self.optimizer)
        self.train_step = lambda state, batch: step(state, self.ref_trainable, batch)
        self._dpo_eval = build_dpo_eval_step(self.model_config, self.config)

    def _tokens_per_sample(self) -> int:
        return 2 * self.config.max_seq_length  # a pair is two sequences

    @staticmethod
    def _real_tokens(batch: Dict[str, np.ndarray]) -> int:
        return int(batch["chosen_attention_mask"].sum() + batch["rejected_attention_mask"].sum())

    def evaluate(self) -> float:
        """The mean DPO loss over the validation pairs; the reward accuracy
        goes to ``extra_eval_logs``. The last batch is wrap-padded, its pad
        rows masked out by ``pair_mask``."""
        self._last_eval_answer = None
        bs = self.config.eval_batch_size or self.config.per_device_batch_size
        n = self.val_arrays["chosen_input_ids"].shape[0]
        if n == 0:
            return float("nan")
        loss_sum = acc_sum = count = 0.0
        for lo in range(0, n, bs):
            batch = {k: v[lo: lo + bs] for k, v in self.val_arrays.items()}
            real = batch["chosen_input_ids"].shape[0]
            pair_mask = np.ones((real,), np.float32)
            if real < bs:
                pad = bs - real
                batch = {k: np.concatenate([v, v[:pad] if pad <= real else
                                            np.repeat(v, -(-pad // real), 0)[:pad]])
                         for k, v in batch.items()}
                pair_mask = np.concatenate([pair_mask, np.zeros((pad,), np.float32)])
            dev = self._device_batch({**batch, "pair_mask": pair_mask})
            l, a, c = self._dpo_eval(self.state, self.ref_trainable, dev)
            loss_sum += float(l)
            acc_sum += float(a)
            count += float(c)
        count = max(count, 1.0)
        self.extra_eval_logs = {"eval_rewards_accuracy": acc_sum / count}
        return loss_sum / count
