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

Checkpoints (``train/checkpoints.py``), as in the JAX trainer: a save every
``save_steps`` and always a final one, the newest/best ``save_total_limit``
kept, the trainable-only payload (``checkpoint_trainable_only``) and the
background snapshot (``checkpoint_async_snapshot``);
``resume_from_checkpoint`` ("latest" or a step) restores the state, falling
back between the two payload modes, and the loader and the learning-rate
schedule go on from the saved step. After every save, process 0 publishes
the trainable weights to ``publish_dir`` (``train/publish.py``), stamped
with the run's lineage and the anomaly sentinels' verdict
(``observe/trainplane.TrainTelemetry``, always built). SIGTERM, or
``request_preemption()``, stops the loop at the next step boundary, writes
an emergency checkpoint and returns.

The fine-tuning recipes, as in the JAX trainer: ``packing=True`` packs the
rows (``data/packing.py``; the counts and steps are in packed rows, and the
forward gets each row's ``segment_ids`` and ``positions``);
``freeze_strategy="lora"`` attaches adapters (``parallel/lora.py``) and
trains only them, ``"qlora"`` also stores the frozen block linears in NF4
(``parallel/qlora.py``, quantized from the f32 init before the bf16 cast),
and both export ``adapter/`` (PEFT) beside the merged ``best_model/``;
``objective="dpo"`` is ``train/dpo.DPOTrainer``, a subclass.

Not ported, and refused by ``check_supported``: SFT's chunked losses,
Adafactor/Lion, sequence parallelism, meshes of more than one device, the
control plane's HTTP server (``train_port``) and the C++ loader. A
checkpoint of the JAX trainer's pipeline layout (``@stacked`` leaves) is
refused at resume: the cross-layout resume waits for pipeline parallelism.
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import statistics
import threading
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
from llm_fine_tune_distributed_tpu_torch.data.packing import (
    build_packed_sft_arrays,
    packing_efficiency,
)
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
from llm_fine_tune_distributed_tpu_torch.observe.trainplane import TrainTelemetry
from llm_fine_tune_distributed_tpu_torch.ops.int8 import dequantize_int8
from llm_fine_tune_distributed_tpu_torch.parallel.freeze import (
    describe_trainable,
    frozen_trunk_boundary,
    quantize_trunk_int8,
    trainable_mask,
)
from llm_fine_tune_distributed_tpu_torch.parallel.lora import (
    add_lora_from_config,
    merge_lora,
    save_lora_adapter,
)
from llm_fine_tune_distributed_tpu_torch.parallel.optimizer import build_optimizer
from llm_fine_tune_distributed_tpu_torch.parallel.qlora import (
    dequantize_frozen,
    quantize_frozen,
    quantized_fraction,
)
from llm_fine_tune_distributed_tpu_torch.runtime.watchdog import StepWatchdog
from llm_fine_tune_distributed_tpu_torch.train.checkpoints import (
    CheckpointManager,
    FingerprintMismatch,
    frozen_fingerprint,
)
from llm_fine_tune_distributed_tpu_torch.train.publish import CheckpointPublisher
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
    if config.objective not in ("sft", "dpo"):
        raise ValueError(f"unknown objective {config.objective!r}; expected 'sft' or 'dpo'")
    sft = config.objective == "sft"  # DPO chunks its logprobs itself (train/dpo.py)
    unported = {
        "loss_chunk_size": (sft and config.loss_chunk_size is not None,
                            "train/step.chunked_ce_sum"),
        "loss_vocab_chunk": (sft and config.loss_vocab_chunk is not None,
                             "train/step.vocab_chunked_ce_sum"),
        f"optimizer={config.optimizer!r}": (
            config.optimizer != "adamw", "parallel/optimizer.build_optimizer"),
        f"attention_impl={config.attention_impl!r}": (
            config.attention_impl in ("ring", "ulysses"), "ops/attention.attention"),
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
        # set by SIGTERM or request_preemption(): checkpoint at the next step
        # boundary and return
        self._preempt = threading.Event()
        self._publisher: Optional[CheckpointPublisher] = None  # made at the first publish
        self._frozen_fp = None  # the frozen leaves' fingerprint, computed once
        # the last train()'s final save and last publish (step, bytes, seconds)
        self.last_checkpoint: Optional[dict] = None
        self.last_publish: Optional[dict] = None
        # eval-time scalars of a subclass (DPO's reward accuracy), logged with
        # every eval
        self.extra_eval_logs: Dict[str, float] = {}
        # seconds of the QLoRA quantization (None without it) and of the
        # export's decoding and merging of the weights
        self.quantize_seconds: Optional[float] = None
        self.export_merge_seconds: Optional[float] = None
        # the run's telemetry: lineage, the anomaly sentinels that gate a
        # publish, the flight recorder (fed at log/eval/save boundaries)
        hparams = {k: (v if isinstance(v, (int, float, str, bool, type(None))) else str(v))
                   for k, v in config.to_dict().items()}
        self.telemetry = TrainTelemetry(hparams=hparams, band_sigma=config.anomaly_band_sigma,
                                        anomaly_window_steps=config.anomaly_window_steps)
        os.makedirs(os.path.join(config.output_dir, "best_model"), exist_ok=True)
        self._prepare_data()
        self._prepare_state()
        self._prepare_steps()

    def _prepare_steps(self) -> None:
        self.train_step = build_train_step(self.model_config, self.config, self.optimizer,
                                           frozen_layers=self.frozen_boundary)
        self.eval_step = build_eval_step(self.model_config, self.config,
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
        build = build_packed_sft_arrays if cfg.packing else build_sft_arrays
        self.train_arrays = build(
            train_rows, self.tokenizer, cfg.max_seq_length, cfg.completion_only_loss, **prompt_kw)
        self.val_arrays = build(
            val_rows, self.tokenizer, cfg.max_seq_length, cfg.completion_only_loss, **prompt_kw)
        if cfg.packing:
            # the counts and the steps are in packed rows (TRL's accounting)
            self.n_train = self.train_arrays["input_ids"].shape[0]
            self.n_val = self.val_arrays["input_ids"].shape[0]
            print(f"Packing: {len(train_rows):,} examples -> {self.n_train:,} rows "
                  f"({100 * packing_efficiency(self.train_arrays):.1f}% token occupancy)")
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
        restricted to the assistant's answer, for ``eval_loss_answer``. The
        same rows tokenize (and pack) to the same layout, which is checked."""
        cfg = self.config
        if cfg.completion_only_loss:
            return  # loss_mask already is the completion span
        build = build_packed_sft_arrays if cfg.packing else build_sft_arrays
        masked = build(val_rows, self.tokenizer, cfg.max_seq_length, True, **prompt_kw)
        if masked["input_ids"].shape != self.val_arrays["input_ids"].shape:
            # a check that survives python -O: the eval metric depends on it
            raise ValueError(
                "completion-mask build produced a different layout than the validation arrays "
                f"(mask {masked['input_ids'].shape} vs val {self.val_arrays['input_ids'].shape}) "
                "— the mask pass must tokenize/pack identically to the eval pass")
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
        # QLoRA keeps the f32 init: NF4 quantizes from full precision
        init_dtype = torch.float32
        if cfg.freeze_strategy != "qlora" and (
                str_to_dtype(cfg.param_dtype) is str_to_dtype(cfg.compute_dtype)):
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
        if cfg.freeze_strategy in ("lora", "qlora"):
            # A Kaiming, B zero: step 0 is the base model; only lora_a and
            # lora_b train, so the optimizer state is the adapters'
            params = add_lora_from_config(params, cfg.seed, cfg)
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
        if cfg.freeze_strategy == "qlora":
            # the frozen block linears to NF4, from full precision
            t0 = time.perf_counter()
            frozen = quantize_frozen(frozen, cfg.quant_block_size, cfg.quant_double_quant)
            self._sync()
            self.quantize_seconds = time.perf_counter() - t0
            print(f"QLoRA: {100 * quantized_fraction(frozen):.1f}% of frozen bytes in NF4 "
                  f"(block {cfg.quant_block_size}, double_quant={cfg.quant_double_quant})")
        if self.frozen_boundary > 0:
            frozen, n_quant = quantize_trunk_int8(frozen, self.frozen_boundary)
            print(f"Frozen trunk: layers [0, {self.frozen_boundary}) run w8a8 int8 "
                  f"({n_quant} projections quantized)")
        param_dtype = str_to_dtype(cfg.param_dtype)
        compute_dtype = str_to_dtype(cfg.compute_dtype)
        # masters: trainable in param_dtype (f32), frozen in compute_dtype;
        # int8 and NF4 codes and their f32 scales keep their dtypes
        trainable = {k: v.detach().to(param_dtype).requires_grad_(True)
                     for k, v in trainable.items()}
        frozen = {k: v.detach().to(compute_dtype)
                  if v.is_floating_point() and "absmax" not in k
                  and not k.endswith("_int8_scale") else v
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
        real attention (and, packed, segment 1) so that each pad token
        still attends to itself."""
        if pad_rows <= 0:
            return arr
        pad_block = np.zeros((pad_rows,) + arr.shape[1:], arr.dtype)
        if key in ("attention_mask", "segment_ids"):
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
        checkpoint (the best among saved checkpoints, restored at the end).
        Checkpoint mode needs every mid-run save to carry a fresh eval, so
        ``save_steps`` must be a multiple of ``eval_steps``; with no mid-run
        save only the final weights can win, which it says."""
        cfg = self.config
        mode = cfg.best_model_tracking
        if mode == "auto":
            trainable_bytes = sum(v.numel() * v.element_size() for v in self.state.trainable.values())
            mode = "per_eval" if trainable_bytes < 512 * 1024**2 else "checkpoint"
        elif mode not in ("per_eval", "checkpoint"):
            raise ValueError(f"unknown best_model_tracking {mode!r}")
        if (mode == "checkpoint" and cfg.load_best_model_at_end and cfg.eval_steps
                and cfg.save_steps and cfg.save_steps % cfg.eval_steps != 0
                and cfg.save_steps <= self.total_steps):
            raise ValueError(
                f"best_model_tracking='checkpoint' needs save_steps ({cfg.save_steps}) to be a "
                f"multiple of eval_steps ({cfg.eval_steps}) so every saved checkpoint carries a "
                "fresh metric — align the cadences or use best_model_tracking='per_eval'")
        if (mode == "checkpoint" and cfg.load_best_model_at_end and cfg.save_steps
                and cfg.save_steps > self.total_steps):
            print(
                f"WARNING: best_model_tracking='checkpoint' with save_steps={cfg.save_steps} > "
                f"total_steps={self.total_steps}: only the end-of-training checkpoint will "
                "exist, so load_best_model_at_end degrades to final-weights-only — lower "
                "save_steps (or use best_model_tracking='per_eval') to track a real best"
            )
        return mode

    def _tokens_per_sample(self) -> int:
        """Data tokens one sample takes (a DPO pair is two sequences)."""
        return self.config.max_seq_length

    @staticmethod
    def _real_tokens(batch: Dict[str, np.ndarray]) -> int:
        """Real (non-pad) tokens of a host batch."""
        return int(batch["attention_mask"].sum())

    def _better(self, a: float, b: float) -> bool:
        return a > b if self.config.greater_is_better else a < b

    # ------------------------------------------------------------ checkpoints

    def _checkpoint_manager(self) -> CheckpointManager:
        cfg = self.config
        return CheckpointManager(os.path.join(cfg.output_dir, "checkpoints"),
                                 max_to_keep=cfg.save_total_limit,
                                 metric_name=cfg.metric_for_best_model,
                                 greater_is_better=cfg.greater_is_better,
                                 trainable_only=cfg.checkpoint_trainable_only)

    def _metric(self, last_eval: Optional[float]) -> Optional[Dict[str, float]]:
        return {self.config.metric_for_best_model: last_eval} if last_eval is not None else None

    def _ckpt_save(self, ckpt: CheckpointManager, step: int, metrics) -> None:
        """Save ``step`` (trainable-only with the frozen fingerprint when so
        configured, as a background snapshot when so configured), then
        publish it."""
        fp = None
        if ckpt.trainable_only or self.config.publish_dir:
            if self._frozen_fp is None:  # the frozen leaves never change
                self._frozen_fp = frozen_fingerprint(self.state.frozen)
            fp = self._frozen_fp
        ckpt.save(step, self.state, metrics=metrics,
                  fingerprint=fp if ckpt.trainable_only else None,
                  snapshot_async=self.config.checkpoint_async_snapshot)
        self._publish(step, fp, metrics)

    def _publish(self, step: int, fp, metrics) -> None:
        """Drop the trainable weights and a manifest into ``publish_dir``
        for a serving engine to hot-swap (one process, so it is process 0).
        A publish whose trailing anomaly window is dirty is stamped so, or
        skipped under ``publish_require_clean``. A failure here is logged,
        never fatal: deployment lag must not kill the fine-tune."""
        cfg = self.config
        if not cfg.publish_dir:
            return
        clean = self.telemetry.publish_clean(step)
        if not clean and cfg.publish_require_clean:
            self.telemetry.note_publish(step, clean=False, skipped=True)
            print(f"[train] skipping publish for step {step}: anomaly window dirty and "
                  "publish_require_clean is set", flush=True)
            return
        try:
            if self._publisher is None:
                self._publisher = CheckpointPublisher(cfg.publish_dir,
                                                      keep_last=cfg.publish_keep_last)
            t0 = time.perf_counter()
            path = self._publisher.publish(
                step, self.state.trainable, frozen_fp=fp, metrics=metrics,
                run_id=self.telemetry.run_id, hparams_digest=self.telemetry.hparams_digest,
                anomaly_clean=clean)
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            self.last_publish = {"step": step, "path": path, "bytes": manifest["bytes"],
                                 "seconds": time.perf_counter() - t0,
                                 "write_s": self._publisher.last_write_s}
            self.telemetry.note_publish(step, clean=clean,
                                        fingerprint=manifest["weight_fingerprint"])
        except Exception as e:  # noqa: BLE001 — an advisory side channel
            print(f"[train] checkpoint publish for step {step} failed: {e}", flush=True)

    def _resume(self, ckpt: CheckpointManager) -> int:
        """Restore ``resume_from_checkpoint`` ("latest", or a step) into the
        state; returns the resumed step (0 when there is nothing to resume).
        A checkpoint of the other payload mode is accepted (both ways); a
        ``FingerprintMismatch`` is raised as it is, never retried."""
        target = str(self.config.resume_from_checkpoint)
        step = ckpt.latest_step if target in ("latest", "true", "1") else int(target)
        if step is None:
            print("No checkpoint found to resume from; starting fresh")
            return 0
        lean = ckpt.trainable_only
        try:
            self.state = ckpt.restore(step, self.state)
        except (FingerprintMismatch, NotImplementedError):
            raise  # a wrong base or a pipeline layout: the other mode would not help
        except Exception as e:
            try:
                self.state = ckpt.restore(step, self.state, trainable_only=not lean)
            except FingerprintMismatch:
                raise
            except Exception as e2:
                raise RuntimeError(
                    f"failed to restore checkpoint step {step} in either payload mode "
                    f"({'trainable-only' if lean else 'full'}: {e}; the other: {e2})") from e2
            print(f"Resumed {'FULL' if lean else 'trainable-only'} checkpoint step {step} into a "
                  f"{'trainable-only' if lean else 'full-checkpoint'} run"
                  + ("" if lean else " (frozen params re-derived and fingerprint-verified)"))
        self.telemetry.note_restore(self.state.step)
        print(f"Resumed from checkpoint step {self.state.step}")
        return self.state.step

    def request_preemption(self) -> None:
        """Stop the training loop at the next step boundary, write an
        emergency checkpoint and return (exit 0 for the CLI). SIGTERM calls
        it; other threads may too."""
        if not self._preempt.is_set():
            self.telemetry.recorder.record("preemption_requested")
            self.telemetry.update(preempted=True)
        self._preempt.set()

    def _install_sigterm(self):
        """SIGTERM -> ``request_preemption`` (main thread only); returns the
        previous handler, or None where none was installed."""
        if threading.current_thread() is not threading.main_thread():
            return None

        def on_sigterm(signum, frame):
            if not self._preempt.is_set():
                print("[train] SIGTERM: checkpointing at the next step boundary, then exiting "
                      "for restart+resume", flush=True)
            self.request_preemption()

        return signal.signal(signal.SIGTERM, on_sigterm)

    # ------------------------------------------------------------------ train

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        ckpt = self._checkpoint_manager()
        resumed_step = self._resume(ckpt) if cfg.resume_from_checkpoint else 0
        # a mid-epoch resume skips the batches its epoch already consumed
        # (the loader's epochs are deterministic), so no row trains twice
        start_epoch = resumed_step // self.steps_per_epoch
        skip_batches = resumed_step % self.steps_per_epoch
        best_eval = -float("inf") if cfg.greater_is_better else float("inf")
        best_trainable = None
        best_mode = self._resolve_best_mode()
        last_eval: Optional[float] = None
        final_loss = None
        preempted = False
        samples_per_step = cfg.per_device_batch_size * cfg.gradient_accumulation_steps
        print(f"Starting {cfg.objective.upper()}: {cfg.epochs} epochs x {self.steps_per_epoch} "
              f"steps, effective batch {samples_per_step}, device {self.device}")
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        meter = self.throughput = _Throughput(self._tokens_per_sample())
        # the wedged-device detector (runtime/watchdog.py), armed by the
        # first step's poke so that the first step's kernel builds cannot
        # trip it
        watchdog = self.watchdog = (
            StepWatchdog(cfg.watchdog_timeout_s, cfg.watchdog_action, start_paused=True)
            if cfg.watchdog_timeout_s > 0 else None)
        prev_sigterm = self._install_sigterm()
        self.telemetry.update(total_steps=self.total_steps, epochs=cfg.epochs,
                              step=resumed_step, state="training")
        t_start = time.perf_counter()
        step = self.state.step
        try:
            for epoch in range(start_epoch, cfg.epochs):
                batches = self.loader.epoch(epoch)
                if epoch == start_epoch and skip_batches:
                    batches = itertools.islice(batches, skip_batches, None)
                for batch in batches:
                    dev_batch = self._device_batch(batch)
                    t_step = time.perf_counter()
                    self.state, metrics = self.train_step(self.state, dev_batch)
                    self._sync()
                    step += 1
                    meter.update(samples_per_step, self._real_tokens(batch),
                                 time.perf_counter() - t_step)
                    if watchdog is not None:
                        watchdog.poke(step)
                    if self._preempt.is_set():
                        # stop here, where (params, moments, step) agree
                        preempted = True
                        break
                    do_log = ((cfg.logging_first_step and step == 1)
                              or (cfg.logging_steps and step % cfg.logging_steps == 0))
                    do_eval = bool(cfg.eval_steps) and step % cfg.eval_steps == 0 and self.n_val > 0
                    do_save = bool(cfg.save_steps) and step % cfg.save_steps == 0
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
                                **meter.snapshot()}
                        # every scalar the step returns (grad_norm; DPO's rewards_*)
                        logs.update({k: float(v) for k, v in metrics.items() if k != "loss"})
                        if do_eval:
                            logs["eval_loss"] = last_eval
                            if self._last_eval_answer is not None:
                                logs["eval_loss_answer"] = self._last_eval_answer
                            logs.update(self.extra_eval_logs)
                        if self.device.type == "cuda":
                            logs["device_bytes_in_use"] = torch.cuda.memory_allocated(self.device)
                            logs["device_peak_bytes_in_use"] = torch.cuda.max_memory_allocated(self.device)
                        self.metrics.log(step, step / self.steps_per_epoch, logs)
                        # the sentinels read the same host floats
                        self.telemetry.on_step(step, logs)
                        self.telemetry.update(epoch=round(step / self.steps_per_epoch, 4))
                        if watchdog is not None:
                            self.telemetry.set_counter("watchdog_trips", watchdog.trips)
                    if do_save:
                        if watchdog is not None:
                            watchdog.pause()  # a save is I/O, not a wedge
                        t_ckpt = time.perf_counter()
                        self._ckpt_save(ckpt, step, self._metric(last_eval))
                        self.telemetry.note_checkpoint(step, time.perf_counter() - t_ckpt)
                    if do_eval or do_save:
                        # crash-safe history at every eval/checkpoint boundary
                        self.metrics.save_history(os.path.join(cfg.output_dir, "training_history.json"))
                if preempted:
                    break
        finally:
            if watchdog is not None:
                # the end of the run (final eval, saves) has no step pokes
                watchdog.stop()
            if prev_sigterm is not None:
                signal.signal(signal.SIGTERM, prev_sigterm)

        if preempted:
            # the emergency checkpoint, then out: the restarted run resumes
            # from here and finishes the eval, the best model and the export
            if ckpt.latest_step != step:
                self._ckpt_save(ckpt, step, self._metric(last_eval))
            ckpt.close()
            print(f"[train] preempted at step {step}: emergency checkpoint saved; exiting "
                  "cleanly for restart+resume", flush=True)
            self.telemetry.update(state="preempted", step=step)
            self.telemetry.recorder.record("emergency_checkpoint", step=step)
            self.metrics.save_history(os.path.join(cfg.output_dir, "training_history.json"))
            return {"preempted": True, "step": step, "final_train_loss": final_loss,
                    "final_eval_loss": last_eval,
                    "wall_clock_seconds": time.perf_counter() - t_start}

        # a final eval when none ran, or when checkpoint-mode selection would
        # otherwise credit the final weights with an older eval
        final_eval_stale = (cfg.load_best_model_at_end and best_mode == "checkpoint"
                            and cfg.eval_steps and step % cfg.eval_steps != 0)
        if (last_eval is None or final_eval_stale) and self.n_val > 0:
            last_eval = self.evaluate()
            if cfg.load_best_model_at_end and self._better(last_eval, best_eval):
                best_eval = last_eval
                best_trainable = None  # the current weights are the best
        self._ckpt_save(ckpt, step, self._metric(last_eval))
        ckpt.wait()
        if cfg.load_best_model_at_end and best_trainable is not None:
            with torch.no_grad():
                for k, v in self.state.trainable.items():
                    v.copy_(best_trainable[k])
        elif cfg.load_best_model_at_end and best_mode == "checkpoint":
            # the best saved checkpoint, read back only when it is not the
            # final step's
            bstep = ckpt.best_step
            if bstep is not None and bstep != step:
                best = ckpt.restore(bstep, self.state)
                with torch.no_grad():
                    for k, v in self.state.trainable.items():
                        v.copy_(best.trainable[k])
                print(f"Restored best checkpoint step {bstep} ({cfg.metric_for_best_model} "
                      "tracking, best_model_tracking=checkpoint)")
        ckpt.close()
        self.last_checkpoint = ckpt.last_save
        self._sync()
        wall = time.perf_counter() - t_start
        self.telemetry.update(state="completed", step=step)
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
        lora = cfg.freeze_strategy in ("lora", "qlora")
        if lora:
            # both forms: the PEFT adapter here, the merged model below
            save_lora_adapter(params, os.path.join(cfg.output_dir, "adapter"), cfg)
        t0 = time.perf_counter()
        if cfg.freeze_strategy == "qlora":
            # the export is plain safetensors: the NF4 base decoded in f32
            params = dequantize_frozen(params, torch.float32)
        for name in [k for k in params if k.endswith(".kernel_int8")]:
            # the int8 trunk is exported as plain kernels, decoded in f32
            q = {"int8": params.pop(name), "int8_scale": params.pop(name + "_scale")}
            params[name[: -len("_int8")]] = dequantize_int8(q, torch.float32)
        if lora:
            params = merge_lora(params)
        self._sync()
        self.export_merge_seconds = time.perf_counter() - t0
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
