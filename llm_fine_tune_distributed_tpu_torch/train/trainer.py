"""SFT trainer on one device (counterpart of the core of the JAX
``train/trainer.py`` ``SFTTrainer``).

Same recipe and cadence: model init (seeded random) or a local HF
checkpoint, the ``last_n_and_head`` freezing policy, the 90/10 split, ChatML
rows, grad-accum microbatches, clip and AdamW with linear decay, logging on
the first step and every ``logging_steps``, a token-weighted eval every
``eval_steps`` (plus the answer-only ``eval_loss_answer``), best-by-eval_loss
weights restored at the end, and the artifact contract: ``best_model/``
(bf16 safetensors, tokenizer marker, ``config.json``),
``training_history.json`` and ``training_summary.json``.

``watchdog_timeout_s`` > 0 arms a ``StepWatchdog`` (``watchdog_action``
"warn" or "abort") that each optimizer step pokes and each eval pauses;
``train`` leaves it on ``self.watchdog`` (its ``trips``).

``frozen_compute="int8"`` runs the frozen trunk (the layers below the first
trainable one) through the w8a8 int8 kernel: its projections are quantized
once from the f32 weights, and ``best_model/`` holds them decoded.

Not ported, and refused by ``check_supported``: packing, DPO, LoRA/QLoRA,
chunked losses, Adafactor/Lion, sequence parallelism,
meshes of more than one device, checkpoints (periodic saves and resume), the
publish directory, the control plane and the C++ loader. The JAX trainer's
final Orbax checkpoint is not written either: ``best_model/`` and the two
JSON files are the artifacts.
"""

from __future__ import annotations

import json
import os
import statistics
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from llm_fine_tune_distributed_tpu_torch.config import TrainConfig, str_to_dtype
from llm_fine_tune_distributed_tpu_torch.data.dataset import (
    build_sft_arrays,
    load_qa_dataset,
    train_validation_split,
)
from llm_fine_tune_distributed_tpu_torch.data.loader import SFTBatchLoader
from llm_fine_tune_distributed_tpu_torch.data.tokenizer import load_tokenizer
from llm_fine_tune_distributed_tpu_torch.device import resolve_device
from llm_fine_tune_distributed_tpu_torch.models.configs import (
    ModelConfig,
    get_preset,
    load_model_config,
    to_hf_dict,
)
from llm_fine_tune_distributed_tpu_torch.models.hf_io import load_hf_checkpoint, save_hf_checkpoint
from llm_fine_tune_distributed_tpu_torch.models.transformer import init_params
from llm_fine_tune_distributed_tpu_torch.observe.metrics import MetricLogger
from llm_fine_tune_distributed_tpu_torch.ops.int8 import dequantize_int8
from llm_fine_tune_distributed_tpu_torch.parallel.freeze import (
    describe_trainable,
    frozen_trunk_boundary,
    quantize_trunk_int8,
    trainable_mask,
)
from llm_fine_tune_distributed_tpu_torch.parallel.optimizer import build_optimizer
from llm_fine_tune_distributed_tpu_torch.runtime.watchdog import StepWatchdog
from llm_fine_tune_distributed_tpu_torch.train.state import TrainState
from llm_fine_tune_distributed_tpu_torch.train.step import build_eval_step, build_train_step
from llm_fine_tune_distributed_tpu_torch.utils.tree import merge_flat, split_by_mask

_JAX_TRAINER = "llm_fine_tune_distributed_tpu.train.trainer.SFTTrainer"


def check_supported(config: TrainConfig) -> None:
    """Raise ``ValueError`` for a ``frozen_compute`` the JAX trainer refuses
    too, and ``NotImplementedError`` for every knob whose branch is not
    ported, naming the JAX code that has it."""
    if config.frozen_compute not in ("bf16", "int8"):
        raise ValueError(f"unknown frozen_compute {config.frozen_compute!r} "
                         "(expected 'bf16' or 'int8')")
    if config.frozen_compute == "int8" and config.objective != "sft":
        raise ValueError("frozen_compute='int8' supports objective='sft' only "
                         f"({_JAX_TRAINER}._prepare_state refuses it too)")
    unported = {
        "packing=True": (config.packing, "_prepare_data (data/packing.py)"),
        f"objective={config.objective!r}": (
            config.objective != "sft", "llm_fine_tune_distributed_tpu.train.dpo.DPOTrainer"),
        f"freeze_strategy={config.freeze_strategy!r}": (
            config.freeze_strategy in ("lora", "qlora"), "_prepare_state (parallel/lora.py, qlora.py)"),
        "loss_chunk_size": (config.loss_chunk_size is not None, "train/step.chunked_ce_sum"),
        "loss_vocab_chunk": (config.loss_vocab_chunk is not None, "train/step.vocab_chunked_ce_sum"),
        f"optimizer={config.optimizer!r}": (
            config.optimizer != "adamw", "parallel/optimizer.build_optimizer"),
        f"attention_impl={config.attention_impl!r}": (
            config.attention_impl in ("ring", "ulysses"), "ops/attention.attention"),
        "resume_from_checkpoint": (bool(config.resume_from_checkpoint), "_resume"),
        "publish_dir": (bool(config.publish_dir), "_publish (train/publish.py)"),
        "train_port": (config.train_port is not None, "observe/trainplane.TrainControlPlane"),
        "use_native_loader=True": (config.use_native_loader, "data/native_loader.NativeBatchLoader"),
    }
    for knob, (on, where) in unported.items():
        if on:
            raise NotImplementedError(
                f"{knob} is not ported to the PyTorch trainer ({_JAX_TRAINER}: {where})"
            )
    try:
        config.mesh.axis_sizes(1)
    except ValueError:
        raise NotImplementedError(
            f"mesh {config.mesh} spans more than one device; the PyTorch trainer runs on "
            f"one device ({_JAX_TRAINER} shards over a JAX mesh)"
        ) from None


class _Throughput:
    """Samples and real (non-pad) tokens per second per card over the run,
    and the median step time (every step ends in a device synchronize)."""

    def __init__(self, tokens_per_sample: int):
        self.tokens_per_sample = tokens_per_sample
        self.t0 = time.perf_counter()
        self.samples = 0
        self.real_tokens = 0
        self.step_s: list = []            # seconds of each optimizer step
        self.step_real_tokens: list = []  # non-pad tokens of each step

    def update(self, samples: int, real_tokens: int, step_s: float) -> None:
        self.samples += samples
        self.real_tokens += real_tokens
        self.step_s.append(step_s)
        self.step_real_tokens.append(real_tokens)

    def snapshot(self) -> Dict[str, float]:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        sps = self.samples / dt
        out = {
            "samples_per_second": sps,
            "samples_per_second_per_chip": sps,
            "steps_per_second": len(self.step_s) / dt,
            "elapsed_seconds": dt,
            "tokens_per_second_per_chip": sps * self.tokens_per_sample,
            "real_tokens_per_second_per_chip": self.real_tokens / dt,
        }
        if self.step_s:
            out["step_seconds_median"] = statistics.median(self.step_s)
        return out


class SFTTrainer:
    def __init__(self, config: TrainConfig, model_config: Optional[ModelConfig] = None,
                 tokenizer=None, *, device=None):
        check_supported(config)
        self.config = config
        self.device = resolve_device(device)
        self.model_config = model_config or self._resolve_model_config(config)
        self.tokenizer = tokenizer or load_tokenizer(config.tokenizer_path or config.model_name)
        self.metrics = MetricLogger()
        self.watchdog: Optional[StepWatchdog] = None  # the last train()'s
        os.makedirs(os.path.join(config.output_dir, "best_model"), exist_ok=True)
        self._prepare_data()
        if config.save_steps and config.save_steps <= self.total_steps:
            raise NotImplementedError(
                f"save_steps={config.save_steps} <= {self.total_steps} total steps would write "
                f"a periodic checkpoint; checkpoints are not ported ({_JAX_TRAINER}._ckpt_save)"
            )
        self._prepare_state()
        self.train_step = build_train_step(self.model_config, config, self.optimizer,
                                           frozen_layers=self.frozen_boundary)
        self.eval_step = build_eval_step(self.model_config, config,
                                         frozen_layers=self.frozen_boundary)

    @staticmethod
    def _resolve_model_config(config: TrainConfig) -> ModelConfig:
        """An explicit preset wins; with ``model_preset`` None or "none" the
        architecture comes from ``model_name``'s ``config.json``."""
        preset = config.model_preset
        if isinstance(preset, str) and preset.lower() == "none":
            preset = None
        if preset:
            return get_preset(preset)
        try:
            return load_model_config(config.model_name or "")
        except FileNotFoundError as e:
            raise ValueError(
                f"model_preset is None and model_name ({config.model_name!r}) is not a local "
                "HF checkpoint directory with a config.json"
            ) from e

    # ------------------------------------------------------------------ data

    def _prompt_kwargs(self) -> Dict[str, Any]:
        if self.config.system_prompt is not None:
            return {"system_prompt": self.config.system_prompt}
        return {}

    def _prepare_data(self) -> None:
        cfg = self.config
        rows = load_qa_dataset(os.path.join(cfg.data_dir, cfg.dataset_file))
        print(f"Total dataset size: {len(rows):,} Q&A pairs")
        train_rows, val_rows = train_validation_split(
            rows, test_size=cfg.validation_fraction, seed=cfg.split_seed)
        self.n_train, self.n_val = len(train_rows), len(val_rows)
        print(f"Training samples: {self.n_train:,}")
        print(f"Validation samples: {self.n_val:,}")
        prompt_kw = self._prompt_kwargs()
        self.train_arrays = build_sft_arrays(
            train_rows, self.tokenizer, cfg.max_seq_length, cfg.completion_only_loss, **prompt_kw)
        self.val_arrays = build_sft_arrays(
            val_rows, self.tokenizer, cfg.max_seq_length, cfg.completion_only_loss, **prompt_kw)
        self._attach_completion_mask(val_rows, prompt_kw)
        self.loader = SFTBatchLoader(
            self.train_arrays, per_device_batch_size=cfg.per_device_batch_size,
            grad_accum_steps=cfg.gradient_accumulation_steps, seed=cfg.seed,
            drop_last=cfg.drop_last,
        )
        self.steps_per_epoch = self.loader.steps_per_epoch
        self.total_steps = self.steps_per_epoch * cfg.epochs

    def _attach_completion_mask(self, val_rows, prompt_kw) -> None:
        """``completion_mask`` on the validation arrays: the loss mask
        restricted to the assistant's answer, for ``eval_loss_answer``."""
        cfg = self.config
        if cfg.completion_only_loss:
            return  # loss_mask already is the completion span
        masked = build_sft_arrays(val_rows, self.tokenizer, cfg.max_seq_length, True, **prompt_kw)
        self.val_arrays["completion_mask"] = masked["loss_mask"]
        if masked["loss_mask"].sum() == 0:
            print(
                "WARNING: every validation completion was truncated away "
                f"(max_seq_length={cfg.max_seq_length} too small for the prompt) — the model "
                "will never train on answer tokens. Raise MAX_SEQ_LENGTH or shorten the "
                "system prompt."
            )

    # ----------------------------------------------------------------- state

    def _load_or_init_params(self):
        cfg, mc = self.config, self.model_config
        source = cfg.model_name
        if source and (os.path.isdir(source) or source.endswith(".safetensors")):
            print(f"Loading model weights from: {source}")
            return load_hf_checkpoint(source, mc, dtype=torch.float32, device=self.device)
        print(f"No local checkpoint at {source!r}; random-initializing {mc.name} "
              f"({mc.num_params:,} params)")
        init_dtype = torch.float32
        if str_to_dtype(cfg.param_dtype) is str_to_dtype(cfg.compute_dtype):
            init_dtype = str_to_dtype(cfg.param_dtype)
        return init_params(mc, seed=cfg.seed, device=self.device, dtype=init_dtype)

    def _prepare_state(self) -> None:
        cfg, mc = self.config, self.model_config
        remat_policy = cfg.resolved_remat_policy(mc)
        if cfg.gradient_checkpointing and remat_policy not in ("full", "dots_no_batch"):
            raise NotImplementedError(
                f"remat_policy={remat_policy!r} is not ported "
                "(llm_fine_tune_distributed_tpu.models.transformer.forward has it)"
            )
        params = self._load_or_init_params()
        mask = trainable_mask(params, mc, cfg)
        self.trainable_report = describe_trainable(params, mask)
        r = self.trainable_report
        print(f"Trainable: {r['trainable_parameters']:,}/{r['total_parameters']:,} "
              f"({r['trainable_percent']}%)")
        trainable, frozen = split_by_mask(params, mask)
        del params
        # the frozen trunk: layers below the first trainable one, quantized
        # to int8 from the full-precision weights, before the cast below
        self.frozen_boundary = 0
        if cfg.frozen_compute == "int8":
            self.frozen_boundary = frozen_trunk_boundary(mask, mc.num_layers)
        if self.frozen_boundary > 0:
            frozen, n_quant = quantize_trunk_int8(frozen, self.frozen_boundary)
            print(f"Frozen trunk: layers [0, {self.frozen_boundary}) run w8a8 int8 "
                  f"({n_quant} projections quantized)")
        param_dtype = str_to_dtype(cfg.param_dtype)
        compute_dtype = str_to_dtype(cfg.compute_dtype)
        # masters: trainable in param_dtype (f32), frozen in compute_dtype;
        # int8 codes and their f32 scales keep their dtypes
        trainable = {k: v.detach().to(param_dtype).requires_grad_(True)
                     for k, v in trainable.items()}
        frozen = {k: v.detach().to(compute_dtype)
                  if v.is_floating_point() and not k.endswith("_int8_scale") else v
                  for k, v in frozen.items()}
        self.optimizer = build_optimizer(cfg, total_steps=self.total_steps)
        self.lr_schedule = self.optimizer.schedule
        self.state = TrainState(step=0, trainable=trainable, frozen=frozen,
                                opt_state=self.optimizer.init(trainable))

    def _device_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ eval

    @staticmethod
    def _pad_eval_rows(key: str, arr: np.ndarray, pad_rows: int) -> np.ndarray:
        """Pad rows for the last eval batch: zero loss mask (no tokens), but
        real attention so no attention row is fully masked."""
        if pad_rows <= 0:
            return arr
        pad_block = np.zeros((pad_rows,) + arr.shape[1:], arr.dtype)
        if key == "attention_mask":
            pad_block[:] = 1
        return np.concatenate([arr, pad_block])

    def evaluate(self) -> float:
        """Token-weighted eval loss over the validation split; the
        answer-only loss of the same forward is kept on
        ``self._last_eval_answer``."""
        cfg = self.config
        bs = cfg.eval_batch_size or cfg.per_device_batch_size
        n = self.val_arrays["input_ids"].shape[0]
        self._last_eval_answer = None
        if n == 0:
            return float("nan")
        sums = None
        for lo in range(0, n, bs):
            batch = {k: v[lo:lo + bs] for k, v in self.val_arrays.items() if k != "lengths"}
            short = bs - batch["input_ids"].shape[0]
            batch = {k: self._pad_eval_rows(k, v, short) for k, v in batch.items()}
            out = self.eval_step(self.state, self._device_batch(batch))
            sums = list(out) if sums is None else [a + b for a, b in zip(sums, out)]
        sums = [float(x) for x in sums]
        if len(sums) == 4 and sums[3] > 0:
            self._last_eval_answer = sums[2] / sums[3]
        return sums[0] / max(sums[1], 1.0)

    # ------------------------------------------------------------------ train

    def _resolve_best_mode(self) -> str:
        """"auto": per_eval under 512 MiB of trainable masters, else
        checkpoint. No checkpoint is written here (a periodic one is refused
        at construction), so checkpoint mode keeps the final weights, as
        the JAX trainer does when only its end-of-run checkpoint exists."""
        cfg = self.config
        mode = cfg.best_model_tracking
        if mode == "auto":
            trainable_bytes = sum(v.numel() * v.element_size() for v in self.state.trainable.values())
            mode = "per_eval" if trainable_bytes < 512 * 1024**2 else "checkpoint"
        elif mode not in ("per_eval", "checkpoint"):
            raise ValueError(f"unknown best_model_tracking {mode!r}")
        if mode == "checkpoint" and cfg.load_best_model_at_end and cfg.save_steps:
            print(
                f"WARNING: best_model_tracking='checkpoint' with save_steps={cfg.save_steps} > "
                f"total_steps={self.total_steps}: only the end-of-training checkpoint will "
                "exist, so load_best_model_at_end degrades to final-weights-only — lower "
                "save_steps (or use best_model_tracking='per_eval') to track a real best"
            )
        return mode

    def _better(self, a: float, b: float) -> bool:
        return a > b if self.config.greater_is_better else a < b

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        best_eval = -float("inf") if cfg.greater_is_better else float("inf")
        best_trainable = None
        best_mode = self._resolve_best_mode()
        last_eval: Optional[float] = None
        final_loss = None
        samples_per_step = cfg.per_device_batch_size * cfg.gradient_accumulation_steps
        print(f"Starting SFT: {cfg.epochs} epochs x {self.steps_per_epoch} steps, effective "
              f"batch {samples_per_step}, device {self.device}")
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        meter = self.throughput = _Throughput(cfg.max_seq_length)
        # the wedged-device detector (runtime/watchdog.py), armed by the
        # first step's poke so that the first step's kernel builds cannot
        # trip it
        watchdog = self.watchdog = (
            StepWatchdog(cfg.watchdog_timeout_s, cfg.watchdog_action, start_paused=True)
            if cfg.watchdog_timeout_s > 0 else None)
        t_start = time.perf_counter()
        step = self.state.step
        try:
            for epoch in range(cfg.epochs):
                for batch in self.loader.epoch(epoch):
                    dev_batch = self._device_batch(batch)
                    t_step = time.perf_counter()
                    self.state, metrics = self.train_step(self.state, dev_batch)
                    self._sync()
                    step += 1
                    meter.update(samples_per_step, int(batch["attention_mask"].sum()),
                                 time.perf_counter() - t_step)
                    if watchdog is not None:
                        watchdog.poke(step)
                    do_log = ((cfg.logging_first_step and step == 1)
                              or (cfg.logging_steps and step % cfg.logging_steps == 0))
                    do_eval = bool(cfg.eval_steps) and step % cfg.eval_steps == 0 and self.n_val > 0
                    if do_eval:
                        if watchdog is not None:
                            # an eval sweep has no step pokes; the next
                            # step's poke re-arms
                            watchdog.pause()
                        last_eval = self.evaluate()
                        if self._better(last_eval, best_eval):
                            best_eval = last_eval
                            if cfg.load_best_model_at_end and best_mode == "per_eval":
                                best_trainable = {k: v.detach().clone()
                                                  for k, v in self.state.trainable.items()}
                    if do_log or do_eval:
                        final_loss = float(metrics["loss"])
                        logs = {"loss": final_loss,
                                "learning_rate": float(self.lr_schedule(step - 1)),
                                **meter.snapshot(),
                                "grad_norm": float(metrics["grad_norm"])}
                        if do_eval:
                            logs["eval_loss"] = last_eval
                            if self._last_eval_answer is not None:
                                logs["eval_loss_answer"] = self._last_eval_answer
                        if self.device.type == "cuda":
                            logs["device_bytes_in_use"] = torch.cuda.memory_allocated(self.device)
                            logs["device_peak_bytes_in_use"] = torch.cuda.max_memory_allocated(self.device)
                        self.metrics.log(step, step / self.steps_per_epoch, logs)
                    if do_eval:
                        self.metrics.save_history(os.path.join(cfg.output_dir, "training_history.json"))
        finally:
            if watchdog is not None:
                # the end of the run (final eval, saves) has no step pokes
                watchdog.stop()

        # a final eval when none ran, or when checkpoint-mode selection would
        # otherwise credit the final weights with an older eval
        final_eval_stale = (cfg.load_best_model_at_end and best_mode == "checkpoint"
                            and cfg.eval_steps and step % cfg.eval_steps != 0)
        if (last_eval is None or final_eval_stale) and self.n_val > 0:
            last_eval = self.evaluate()
            if cfg.load_best_model_at_end and self._better(last_eval, best_eval):
                best_eval = last_eval
                best_trainable = None  # the current weights are the best
        if cfg.load_best_model_at_end and best_trainable is not None:
            with torch.no_grad():
                for k, v in self.state.trainable.items():
                    v.copy_(best_trainable[k])
        self._sync()
        wall = time.perf_counter() - t_start
        return self._save_artifacts(final_loss, last_eval, wall, meter.snapshot())

    def _save_artifacts(self, final_loss, eval_loss, wall_seconds: float,
                        throughput: Dict[str, float]) -> Dict[str, Any]:
        """``best_model/`` (bf16 safetensors, tokenizer, config.json),
        ``training_history.json`` and ``training_summary.json`` with the
        reference keys."""
        cfg = self.config
        summary = {
            "model_name": cfg.model_name,
            "dataset_path": os.path.join(cfg.data_dir, cfg.dataset_file),
            "epochs": cfg.epochs,
            "batch_size": cfg.per_device_batch_size,
            "learning_rate": cfg.learning_rate,
            "trainable_params": self.trainable_report["trainable_parameters"],
            "total_params": self.trainable_report["total_parameters"],
            "training_samples": self.n_train,
            "validation_samples": self.n_val,
            "final_train_loss": final_loss,
            "world_size": 1,
            "distributed_training": False,
            "final_eval_loss": eval_loss,
            "wall_clock_seconds": round(wall_seconds, 2),
            "device": (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu"),
            **{k: round(v, 4) for k, v in throughput.items()},
        }
        if self.device.type == "cuda":
            summary["device_peak_bytes_in_use"] = torch.cuda.max_memory_allocated(self.device)
        best_dir = os.path.join(cfg.output_dir, "best_model")
        params = {k: v.detach() for k, v in merge_flat(self.state.trainable, self.state.frozen).items()}
        for name in [k for k in params if k.endswith(".kernel_int8")]:
            # the int8 trunk is exported as plain kernels, decoded in f32
            q = {"int8": params.pop(name), "int8_scale": params.pop(name + "_scale")}
            params[name[: -len("_int8")]] = dequantize_int8(q, torch.float32)
        save_hf_checkpoint(params, best_dir, save_dtype=torch.bfloat16,
                           metadata={"framework": "llm_fine_tune_distributed_tpu_torch"})
        if hasattr(self.tokenizer, "save_pretrained"):
            self.tokenizer.save_pretrained(best_dir)
        with open(os.path.join(best_dir, "config.json"), "w") as f:
            json.dump(to_hf_dict(self.model_config), f, indent=2)
        print(f"Best model saved to {best_dir}")
        self.metrics.save_history(os.path.join(cfg.output_dir, "training_history.json"))
        with open(os.path.join(cfg.output_dir, "training_summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        return summary
