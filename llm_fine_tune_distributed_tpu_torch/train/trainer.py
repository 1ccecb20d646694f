"""SFT trainer on one device or data-parallel over processes (counterpart
of the core of the JAX ``train/trainer.py`` ``SFTTrainer``).

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

Data parallelism over processes (``runtime/distributed.py``,
``runtime/mesh.py``), as the JAX trainer shards over its mesh's (data,
fsdp) axes: each rank takes its columns of every global batch
(``_loader_kwargs``), the loss is the token mean over the global
microbatch, one bucketed all-reduce per step sums the gradients
(``train/step.py``), and AdamW runs on each rank's fsdp slice of the
leaves (ZeRO-3, ``parallel/optimizer.FsdpShards``: each rank takes the
model one leaf at a time and keeps its slices of the leaves the fsdp rules
split, trainable and frozen, gathers a block's leaves as the block runs,
and reduce-scatters their gradients; checkpoints, publishes and
``best_model/`` get the leaves gathered whole one at a time, kept by rank 0
alone, so a checkpoint resumes at any world size). The eval is split
over the ranks and its sums all-reduced. Rank 0 alone prints, writes the
history, the checkpoints, ``best_model/`` and the summary, and publishes;
the other ranks join the collectives (the moments' gathers) and wait at a
barrier at the end. The per-rank decisions that change the sequence of
collectives (preemption, the watchdog's abort, best-model selection, the
anomaly gate of a publish) are agreed by every rank with one small
all-reduce (``runtime/distributed.agree``); ``desync_check_steps`` checks
that the replicas of the trainable leaves stay equal.

Tensor parallelism (``MESH_TENSOR``, ``parallel/sharding.TensorShards``),
as the JAX trainer shards over its mesh's tensor axis: the ranks of a
tensor group read the same rows; each rank takes the model one leaf at a
time, whole, and keeps its tensor slice of it, then its fsdp slice of that
slice; the forward issues Megatron's collectives under autograd
(``models/transformer``) and the loss is vocab-parallel
(``train/step.vocab_parallel_ce``); the gradients and the loss are summed
over the ranks of one tensor index; saves, publishes and ``best_model/``
gather every leaf over fsdp, then over tensor, one leaf at a time, and a
restore slices the whole files for the current layout, so a checkpoint of
any layout resumes at any other.

The heartbeat failure detector (``runtime/failure.py`` over the port's
own ``native/heartbeat.cc``) runs with ``heartbeat=True``, and by itself
over processes, as in the JAX trainer: when it cannot start, an explicit
``heartbeat=True`` raises and the automatic one prints why and goes on.
Rank 0's coordinator's dead ranks, polled between steps, go into the step
boundary's agreement, and every rank stops with ``RuntimeError`` at that
step.

Not ported, and refused by ``check_supported``: SFT's chunked losses,
Adafactor/Lion, sequence parallelism, the mesh axes other than data, fsdp
and tensor (``runtime/mesh``), a tensor axis that does not divide the kv
heads (the JAX ``_validate_spec`` replicates those leaves), the control
plane's HTTP server (``train_port``) and the C++ loader. A
checkpoint of the JAX trainer's pipeline layout (``@stacked`` leaves) is
refused at resume: the cross-layout resume waits for pipeline parallelism.
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import statistics
import sys
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
from llm_fine_tune_distributed_tpu_torch.models.transformer import iter_init_params, param_shapes
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
from llm_fine_tune_distributed_tpu_torch.parallel.optimizer import FsdpShards, build_optimizer
from llm_fine_tune_distributed_tpu_torch.parallel.qlora import (
    dequantize_frozen,
    quantize_frozen,
    quantize_frozen_abstract,
    quantized_fraction,
)
from llm_fine_tune_distributed_tpu_torch.parallel.sharding import TensorShards
from llm_fine_tune_distributed_tpu_torch.runtime.desync import DesyncMonitor
from llm_fine_tune_distributed_tpu_torch.runtime.failure import FailureDetector
from llm_fine_tune_distributed_tpu_torch.runtime.distributed import (
    agree,
    all_reduce_,
    barrier,
    broadcast_int,
    is_distributed,
    is_primary_host,
    print0,
    process_count,
)
from llm_fine_tune_distributed_tpu_torch.runtime.mesh import (
    data_parallel_size,
    describe_mesh,
    grad_reduction,
    make_mesh,
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


class _Throughput:
    """Samples and real (non-pad) tokens per second, over the run and per
    card of the ``n_chips`` that share the global batch, and the median step
    time (every step ends in a device synchronize)."""

    def __init__(self, tokens_per_sample: int, n_chips: int = 1, replicas: int = 1):
        self.tokens_per_sample = tokens_per_sample
        self.n_chips = n_chips
        self.replicas = replicas  # the data-parallel size: the cards that split the samples
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
            "samples_per_second_per_chip": sps / self.replicas,
            "steps_per_second": len(self.step_s) / dt,
            "elapsed_seconds": dt,
            "tokens_per_second_per_chip": sps * self.tokens_per_sample / self.n_chips,
            "real_tokens_per_second_per_chip": self.real_tokens / dt / self.n_chips,
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
        # the ranks of the process group as the JAX mesh's devices (one
        # device per process); without a group, a mesh of one
        self.mesh = make_mesh(config.mesh)
        self.dp_size = data_parallel_size(self.mesh)
        self.distributed = is_distributed()
        self.primary = is_primary_host()
        self.model_config = model_config or self._resolve_model_config(config)
        # the tensor axis (None: 1): this rank's slice of each leaf
        self.tensor = TensorShards.for_mesh(self.mesh, self.model_config)
        self.reduction = grad_reduction(self.mesh)
        self.tokenizer = tokenizer or load_tokenizer(config.tokenizer_path or config.model_name)
        self.metrics = MetricLogger(echo=self.primary)
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
        # set by the watchdog's abort under data parallelism, for every rank
        # to agree on at the next step boundary
        self._watchdog_abort = threading.Event()
        # the heartbeat failure detector of the last train() (None: off)
        self.detector: Optional[FailureDetector] = None
        self._saved_step: Optional[int] = None  # the last step a save was issued for
        # the run's telemetry: lineage, the anomaly sentinels that gate a
        # publish, the flight recorder (fed at log/eval/save boundaries)
        hparams = {k: (v if isinstance(v, (int, float, str, bool, type(None))) else str(v))
                   for k, v in config.to_dict().items()}
        self.telemetry = TrainTelemetry(hparams=hparams, band_sigma=config.anomaly_band_sigma,
                                        anomaly_window_steps=config.anomaly_window_steps)
        if self.primary:
            os.makedirs(os.path.join(config.output_dir, "best_model"), exist_ok=True)
        if self.mesh.size > 1:
            print0(f"{'Tensor and data' if self.tensor else 'Data'} parallel: "
                   f"{describe_mesh(self.mesh)}, rank {self.mesh.rank}")
        self._prepare_data()
        self._prepare_state()
        self._prepare_steps()

    def _prepare_steps(self) -> None:
        self.train_step = build_train_step(self.model_config, self.config, self.optimizer,
                                           frozen_layers=self.frozen_boundary,
                                           shards=self.shards, tensor=self.tensor,
                                           reduction=self.reduction)
        self.eval_step = build_eval_step(self.model_config, self.config,
                                         frozen_layers=self.frozen_boundary, shards=self.shards,
                                         tensor=self.tensor)

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

    def _process_batch_rows(self) -> tuple:
        """(row_start, row_count): this rank's contiguous rows of each
        microbatch's global batch, which is split over (data, fsdp) in rank
        order, one device per rank."""
        bs = self.config.per_device_batch_size
        return self.mesh.batch_block * bs, bs

    def _loader_kwargs(self) -> Dict[str, Any]:
        """Batch-loader kwargs (shared SFT/DPO, so the sharding cannot drift)."""
        cfg = self.config
        row_start, row_count = self._process_batch_rows()
        return dict(per_device_batch_size=cfg.per_device_batch_size,
                    grad_accum_steps=cfg.gradient_accumulation_steps,
                    data_parallel_size=self.dp_size, process_index=self.mesh.rank,
                    process_count=self.mesh.size, seed=cfg.seed, drop_last=cfg.drop_last,
                    row_start=row_start, row_count=row_count)

    def _prepare_data(self) -> None:
        cfg = self.config
        rows = load_qa_dataset(os.path.join(cfg.data_dir, cfg.dataset_file))
        print0(f"Total dataset size: {len(rows):,} Q&A pairs")
        train_rows, val_rows = train_validation_split(
            rows, test_size=cfg.validation_fraction, seed=cfg.split_seed)
        self.n_train, self.n_val = len(train_rows), len(val_rows)
        print0(f"Training samples: {self.n_train:,}")
        print0(f"Validation samples: {self.n_val:,}")
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
            print0(f"Packing: {len(train_rows):,} examples -> {self.n_train:,} rows "
                   f"({100 * packing_efficiency(self.train_arrays):.1f}% token occupancy)")
        self._attach_completion_mask(val_rows, prompt_kw)
        self.loader = SFTBatchLoader(self.train_arrays, **self._loader_kwargs())
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
            print0(
                "WARNING: every validation completion was truncated away "
                f"(max_seq_length={cfg.max_seq_length} too small for the prompt) — the model "
                "will never train on answer tokens. Raise MAX_SEQ_LENGTH or shorten the "
                "system prompt."
            )

    # ----------------------------------------------------------------- state

    def _param_chunks(self):
        """The model's weights, as dicts of leaves: all of them at once,
        or, under ZeRO-3 or a tensor axis (either above 1), one leaf at a
        time (a checkpoint is read to the host, each leaf moved to the
        device in turn), so a rank holds one whole leaf beside its slices."""
        cfg, mc = self.config, self.model_config
        sharded = self.mesh.shape["fsdp"] > 1 or self.tensor is not None
        source = cfg.model_name
        if source and (os.path.isdir(source) or source.endswith(".safetensors")):
            print0(f"Loading model weights from: {source}")
            if not sharded:
                yield load_hf_checkpoint(source, mc, dtype=torch.float32, device=self.device)
                return
            params = load_hf_checkpoint(source, mc, dtype=torch.float32, device="cpu")
            while params:
                name = next(iter(params))
                yield {name: params.pop(name).to(self.device)}
            return
        print0(f"No local checkpoint at {source!r}; random-initializing {mc.name} "
               f"({mc.num_params:,} params)")
        # QLoRA keeps the f32 init: NF4 quantizes from full precision
        init_dtype = torch.float32
        if cfg.freeze_strategy != "qlora" and (
                str_to_dtype(cfg.param_dtype) is str_to_dtype(cfg.compute_dtype)):
            init_dtype = str_to_dtype(cfg.param_dtype)
        leaves = iter_init_params(mc, seed=cfg.seed, device=self.device, dtype=init_dtype)
        if not sharded:
            yield dict(leaves)
            return
        for name, leaf in leaves:
            yield {name: leaf}
            del leaf  # before the next leaf is made

    def _prepare_state(self) -> None:
        cfg, mc = self.config, self.model_config
        remat_policy = cfg.resolved_remat_policy(mc)
        if cfg.gradient_checkpointing and remat_policy not in ("full", "dots_no_batch"):
            raise NotImplementedError(
                f"remat_policy={remat_policy!r} is not ported "
                "(llm_fine_tune_distributed_tpu.models.transformer.forward has it)"
            )
        lora = cfg.freeze_strategy in ("lora", "qlora")
        # the frozen trunk: layers below the first trainable one, quantized
        # to int8 from the full-precision weights, before the cast below;
        # from the leaves' names (LoRA's added on 1 x 1 stand-ins)
        self.frozen_boundary = 0
        if cfg.frozen_compute == "int8":
            names = dict.fromkeys(param_shapes(mc), torch.empty(1, 1))
            if lora:
                names = add_lora_from_config(names, cfg.seed, cfg)
            self.frozen_boundary = frozen_trunk_boundary(trainable_mask(names, mc, cfg),
                                                         mc.num_layers)
        param_dtype = str_to_dtype(cfg.param_dtype)
        compute_dtype = str_to_dtype(cfg.compute_dtype)
        # ZeRO-3 over the fsdp axis (None: every leaf whole): the leaves the
        # rules split, trainable and frozen, kept as this rank's slices
        self.shards = FsdpShards.for_mesh(self.mesh)
        trainable, frozen, mask, shapes, n_quant = {}, {}, {}, {}, 0
        if cfg.freeze_strategy == "qlora":
            self.quantize_seconds = 0.0
        for params in self._param_chunks():
            if lora:
                # A Kaiming, B zero: step 0 is the base model; only lora_a
                # and lora_b train, so the optimizer state is the adapters'
                params = add_lora_from_config(params, cfg.seed, cfg)
            chunk_mask = trainable_mask(params, mc, cfg)
            mask.update(chunk_mask)
            shapes.update((k, torch.empty(v.shape, device="meta")) for k, v in params.items())
            t, f = split_by_mask(params, chunk_mask)
            del params
            if cfg.freeze_strategy == "qlora":
                # the leaves' shapes after quantization: the plan of the fsdp slices
                plan = {k: v.shape for k, v in itertools.chain(t.items(), quantize_frozen_abstract(
                    f, cfg.quant_block_size, cfg.quant_double_quant).items())}
                # the frozen block linears to NF4, from full precision
                t0 = time.perf_counter()
                f = quantize_frozen(f, cfg.quant_block_size, cfg.quant_double_quant)
                self._sync()
                self.quantize_seconds += time.perf_counter() - t0
            if self.frozen_boundary > 0:
                f, n = quantize_trunk_int8(f, self.frozen_boundary)
                n_quant += n
            # masters: trainable in param_dtype (f32), frozen in compute_dtype;
            # int8 and NF4 codes and their f32 scales keep their dtypes
            t = {k: v.detach().to(param_dtype).requires_grad_(True) for k, v in t.items()}
            f = {k: v.detach().to(compute_dtype)
                 if v.is_floating_point() and "absmax" not in k
                 and not k.endswith("_int8_scale") else v
                 for k, v in f.items()}
            if cfg.freeze_strategy == "qlora" and not self.frozen_boundary:
                got = {k: v.shape for k, v in itertools.chain(t.items(), f.items())}
                if got != plan:
                    raise RuntimeError("the NF4 leaves differ from quantize_frozen_abstract's "
                                       f"plan: {sorted(set(got.items()) ^ set(plan.items()))[:4]}")
            if self.tensor is not None:
                # the tensor slice of each whole leaf (NF4 and int8 codes
                # quantized whole above), then its fsdp slice below
                t, f = self.tensor.local_all(t), self.tensor.local_all(f)
            if self.shards is not None:
                t, f = self.shards.take(t), self.shards.take(f)
            trainable.update(t)
            frozen.update(f)
            del t, f
        if cfg.frozen_compute == "int8" and (
                self.frozen_boundary != frozen_trunk_boundary(mask, mc.num_layers)):
            raise RuntimeError("the loaded leaves' names move the frozen trunk's boundary")
        if self.shards is not None and not self.shards.dims:
            self.shards = None
        self.trainable_report = r = describe_trainable(shapes, mask)
        print0(f"Trainable: {r['trainable_parameters']:,}/{r['total_parameters']:,} "
               f"({r['trainable_percent']}%)")
        if cfg.freeze_strategy == "qlora":
            print0(f"QLoRA: {100 * quantized_fraction(frozen):.1f}% of frozen bytes in NF4 "
                   f"(block {cfg.quant_block_size}, double_quant={cfg.quant_double_quant})")
        if self.frozen_boundary > 0:
            print0(f"Frozen trunk: layers [0, {self.frozen_boundary}) run w8a8 int8 "
                   f"({n_quant} projections quantized)")
        self.optimizer = build_optimizer(cfg, total_steps=self.total_steps,
                                         data_parallel_size=self.dp_size)
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

    def _eval_rows(self):
        """(bs, first, stride): this rank's eval batches are rows [first +
        i * stride, + bs) of the validation split: a global batch of bs per
        data-parallel rank, split like a training batch."""
        bs = self.config.eval_batch_size or self.config.per_device_batch_size
        return bs, self.mesh.batch_block * bs, bs * self.dp_size

    def evaluate(self) -> float:
        """Token-weighted eval loss over the validation split; the
        answer-only loss of the same forward is kept on
        ``self._last_eval_answer``. Under data parallelism each rank runs
        its share of the batches and the sums are all-reduced, so the loss
        is the one-device value (to the order of the sums)."""
        bs, first, stride = self._eval_rows()
        n = self.val_arrays["input_ids"].shape[0]
        self._last_eval_answer = None
        if n == 0:
            return float("nan")
        sums = None
        for g in range(0, n, stride):  # every rank runs as many batches
            lo = g + first
            batch = {k: v[lo:lo + bs] for k, v in self.val_arrays.items() if k != "lengths"}
            short = bs - batch["input_ids"].shape[0]
            batch = {k: self._pad_eval_rows(k, v, short) for k, v in batch.items()}
            out = self.eval_step(self.state, self._device_batch(batch))
            sums = list(out) if sums is None else [a + b for a, b in zip(sums, out)]
        if self.reduction[0]:
            sums = all_reduce_(torch.stack([x.float() for x in sums]), self.reduction[1]).unbind()
        sums = [float(x) for x in sums]
        # the loss's floor of one token, per global batch (the JAX eval's
        # batches): one for each global batch without a loss token
        mask = self.val_arrays["loss_mask"][:, 1:]
        sums[1] += sum(int(mask[g:g + stride].sum() == 0) for g in range(0, n, stride))
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
            trainable_bytes = sum(self._numel(k, v) * v.element_size()
                                  for k, v in self.state.trainable.items())
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
            print0(
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

    @staticmethod
    def _loss_tokens(batch: Dict[str, np.ndarray]) -> Optional[np.ndarray]:
        """``[accum]`` token counts of a global batch's microbatches, the
        denominators of the loss's token mean under data parallelism."""
        return np.maximum(batch["loss_mask"][:, :, 1:].sum(axis=(1, 2)), 1).astype(np.float32)

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

    def _numel(self, name: str, t: torch.Tensor) -> int:
        """Elements of the whole leaf ``name`` (``t`` may be its slice)."""
        return self._whole_shape(name, t).numel()

    @property
    def _sliced(self) -> bool:
        """Whether this rank holds slices of some leaves (ZeRO-3 or tensor)."""
        return self.shards is not None or self.tensor is not None

    def _wholes(self, leaves: Dict[str, torch.Tensor]):
        """(name, whole leaf, detached) of ``leaves``, one at a time: its
        fsdp slices gathered over the fsdp group, then its tensor slices
        over the tensor group (a collective: every rank runs it to its
        end); a whole leaf passes as it is."""
        items = self.shards.wholes(leaves) if self.shards is not None else leaves.items()
        for k, v in items:
            if self.tensor is not None:
                v = self.tensor.whole(k, v)
            yield k, v

    def _whole(self, leaves: Dict[str, torch.Tensor], keep: bool = True) -> Dict[str, torch.Tensor]:
        """``leaves`` with every slice gathered whole, one leaf at a time (a
        collective under ZeRO-3 or a tensor axis: every rank calls it); the
        leaves themselves without. With ``keep`` False this rank only takes
        part and gets ``{}``: it never holds more than one whole leaf."""
        if not self._sliced:
            return leaves
        out = {}
        for k, v in self._wholes(leaves):
            if keep:
                out[k] = v
        return out

    def _local(self, whole: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's slices of whole leaves: the tensor slice, then the
        fsdp slice of it."""
        if self.tensor is not None:
            whole = self.tensor.local_all(whole)
        return self.shards.local(whole) if self.shards is not None else whole

    def _full_opt_state(self, keep: bool = True) -> dict:
        """The AdamW state with every sharded moment gathered whole over the
        fsdp axis (a collective: every rank calls it), the layout of a
        one-device run; ``keep`` as in ``_whole``."""
        opt = self.state.opt_state
        return {"count": opt["count"], "mu": self._whole(opt["mu"], keep),
                "nu": self._whole(opt["nu"], keep)}

    def _full_trainable(self, keep: bool = True) -> Dict[str, torch.Tensor]:
        """The trainable leaves whole (a collective under ZeRO-3 or a tensor
        axis: gathered over fsdp, then over tensor)."""
        return self._whole(self.state.trainable, keep)

    def _frozen_fingerprint(self):
        """``frozen_fingerprint`` of the whole frozen leaves: under ZeRO-3 or
        a tensor axis each gathered in turn and dropped (a collective)."""
        if not self._sliced:
            return frozen_fingerprint(self.state.frozen)
        return {k: frozen_fingerprint({k: v})[k] for k, v in self._wholes(self.state.frozen)}

    def _whole_shape(self, name: str, t: torch.Tensor):
        """The whole shape of the leaf ``name`` of which ``t`` is a slice."""
        if self.tensor is not None and self.tensor.sliced(name):
            return self.tensor.shapes[name]
        if self.shards is not None and name in self.shards.dims:
            return self.shards.shapes[name]
        return t.shape

    def _restore(self, ckpt: CheckpointManager, step: int, **kw) -> TrainState:
        """``ckpt.restore`` on every rank: the whole files read, each rank
        keeps its tensor slices, then its fsdp slices, of the leaves and the
        moments. So a checkpoint of any layout resumes at any other. A
        trainable-only restore keeps the frozen slices, checked against the
        saved fingerprint of the whole leaves (gathered one at a time)."""
        if not self._sliced:
            return ckpt.restore(step, self.state, **kw)
        trainable_only = kw.get("trainable_only")
        if trainable_only is None:
            trainable_only = ckpt.trainable_only

        def like(leaves):  # whole shapes, one element of memory each
            out = {}
            for k, v in leaves.items():
                shape = self._whole_shape(k, v)
                out[k] = v if shape == v.shape else torch.zeros(
                    [1] * len(shape), dtype=v.dtype, device=v.device,
                    requires_grad=v.requires_grad).expand(shape)
            return out

        opt = self.state.opt_state
        whole = TrainState(step=self.state.step, trainable=like(self.state.trainable),
                           frozen=like(self.state.frozen),
                           opt_state={"count": opt["count"], "mu": like(opt["mu"]),
                                      "nu": like(opt["nu"])})
        fp = self._frozen_fingerprint() if trainable_only else None
        restored = ckpt.restore(step, whole, fingerprint=fp, **kw)
        local = self._local
        return TrainState(step=restored.step, trainable=local(restored.trainable),
                          frozen=self.state.frozen if trainable_only else local(restored.frozen),
                          opt_state={"count": restored.opt_state["count"],
                                     "mu": local(restored.opt_state["mu"]),
                                     "nu": local(restored.opt_state["nu"])})

    def _ckpt_save(self, ckpt: CheckpointManager, step: int, metrics) -> None:
        """Save ``step`` (trainable-only with the frozen fingerprint when so
        configured, as a background snapshot when so configured), then
        publish it. Under ZeRO-3 every rank takes part in gathering the
        sharded leaves and moments whole, one leaf at a time, and only rank
        0, which writes and publishes, keeps them. The gathers run here, on
        the calling thread: the snapshot's writer thread issues no
        collective."""
        state = self.state
        fp_needed = ckpt.trainable_only or self.config.publish_dir
        if self._sliced:
            if fp_needed and self._frozen_fp is None:  # on every rank: same gathers next time
                self._frozen_fp = self._frozen_fingerprint()
            keep = self.primary
            frozen = {} if ckpt.trainable_only else self._whole(state.frozen, keep)
            state = TrainState(step=state.step, trainable=self._full_trainable(keep),
                               frozen=frozen, opt_state=self._full_opt_state(keep))
        # the anomaly gate of the publish, common to every rank
        clean = agree([self.telemetry.publish_clean(step)], self.device, every=True)[0]
        self._saved_step = step
        if not self.primary:
            return
        fp = None
        if fp_needed:
            if self._frozen_fp is None:  # the frozen leaves never change
                self._frozen_fp = self._frozen_fingerprint()
            fp = self._frozen_fp
        ckpt.save(step, state, metrics=metrics,
                  fingerprint=fp if ckpt.trainable_only else None,
                  snapshot_async=self.config.checkpoint_async_snapshot)
        self._publish(step, state.trainable, fp, metrics, clean)

    def _publish(self, step: int, trainable, fp, metrics, clean: bool) -> None:
        """Drop the (whole) trainable weights and a manifest into ``publish_dir``
        for a serving engine to hot-swap (rank 0 only). A publish whose
        trailing anomaly window is dirty (``clean`` False) is stamped so, or
        skipped under ``publish_require_clean``. A failure here is logged,
        never fatal: deployment lag must not kill the fine-tune."""
        cfg = self.config
        if not cfg.publish_dir or not self.primary:
            return
        if not clean and cfg.publish_require_clean:
            self.telemetry.note_publish(step, clean=False, skipped=True)
            print0(f"[train] skipping publish for step {step}: anomaly window dirty and "
                   "publish_require_clean is set", flush=True)
            return
        try:
            if self._publisher is None:
                self._publisher = CheckpointPublisher(cfg.publish_dir,
                                                      keep_last=cfg.publish_keep_last)
            t0 = time.perf_counter()
            path = self._publisher.publish(
                step, trainable, frozen_fp=fp, metrics=metrics,
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
            print0(f"[train] checkpoint publish for step {step} failed: {e}", flush=True)

    def _resume(self, ckpt: CheckpointManager) -> int:
        """Restore ``resume_from_checkpoint`` ("latest", or a step) into the
        state; returns the resumed step (0 when there is nothing to resume).
        A checkpoint of the other payload mode is accepted (both ways); a
        ``FingerprintMismatch`` is raised as it is, never retried."""
        target = str(self.config.resume_from_checkpoint)
        step = ckpt.latest_step if target in ("latest", "true", "1") else int(target)
        if step is None:
            print0("No checkpoint found to resume from; starting fresh")
            return 0
        lean = ckpt.trainable_only
        try:
            self.state = self._restore(ckpt, step)
        except (FingerprintMismatch, NotImplementedError):
            raise  # a wrong base or a pipeline layout: the other mode would not help
        except Exception as e:
            try:
                self.state = self._restore(ckpt, step, trainable_only=not lean)
            except FingerprintMismatch:
                raise
            except Exception as e2:
                raise RuntimeError(
                    f"failed to restore checkpoint step {step} in either payload mode "
                    f"({'trainable-only' if lean else 'full'}: {e}; the other: {e2})") from e2
            print0(f"Resumed {'FULL' if lean else 'trainable-only'} checkpoint step {step} into a "
                   f"{'trainable-only' if lean else 'full-checkpoint'} run"
                   + ("" if lean else " (frozen params re-derived and fingerprint-verified)"))
        self.telemetry.note_restore(self.state.step)
        print0(f"Resumed from checkpoint step {self.state.step}")
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

    def _on_watchdog_abort(self) -> None:
        """The watchdog's abort under data parallelism: flag it for every
        rank to agree on at the next step boundary, and end this process
        after one more timeout if that boundary never comes (a wedged
        device)."""
        self._watchdog_abort.set()
        timer = threading.Timer(self.config.watchdog_timeout_s, os._exit, args=(42,))
        timer.daemon = True
        timer.start()

    def _start_detector(self) -> Optional[FailureDetector]:
        """The heartbeat failure detector on every rank (``heartbeat=True``,
        or by itself over processes, as in the JAX trainer); a collective.
        Where it cannot start, ``heartbeat=True`` raises, the automatic one
        prints why and runs without."""
        cfg = self.config
        if not (cfg.heartbeat or process_count() > 1):
            return None
        try:
            return FailureDetector.for_group(self.device, port=cfg.heartbeat_port,
                                             timeout_ms=cfg.heartbeat_timeout_ms)
        except RuntimeError as e:
            if cfg.heartbeat:
                raise
            print0(f"[runtime] heartbeat unavailable: {e}")
            return None

    def _step_boundary(self, step: int) -> bool:
        """The decisions every rank takes together after each step (one
        small all-reduce under data parallelism): an abort of the watchdog
        on any rank ends every rank (exit 42, for the job manager to restart
        the job); ranks that stopped heartbeating (rank 0's detector) stop
        every rank with ``RuntimeError``, for a restart and a resume from the
        last periodic checkpoint (no save: a save's gathers need every rank);
        a preemption on any rank stops every rank here. Returns whether to
        stop."""
        dead = self.detector.dead_ranks() if self.detector is not None else []
        preempt, abort, silent = agree([self._preempt.is_set(), self._watchdog_abort.is_set(),
                                        bool(dead)], self.device)
        if silent:
            raise RuntimeError(f"ranks {dead or '(seen by rank 0)'} stopped heartbeating at step "
                               f"{step}; aborting for restart+resume")
        if abort:
            print(f"[watchdog] rank {self.mesh.rank}: abort agreed at step {step}; exiting for a "
                  "restart", file=sys.stderr, flush=True)
            sys.stdout.flush()
            os._exit(42)
        if preempt and not self._preempt.is_set():
            self.request_preemption()  # another rank's SIGTERM
        return preempt

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        ckpt = self._checkpoint_manager()
        resumed_step = self._resume(ckpt) if cfg.resume_from_checkpoint else 0
        self._saved_step = resumed_step if resumed_step else None
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
        samples_per_step = cfg.per_device_batch_size * cfg.gradient_accumulation_steps * self.dp_size
        print0(f"Starting {cfg.objective.upper()}: {cfg.epochs} epochs x {self.steps_per_epoch} "
               f"steps, effective batch {samples_per_step}, device {self.device}"
               + (f", {describe_mesh(self.mesh)}" if self.distributed else ""))
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        meter = self.throughput = _Throughput(self._tokens_per_sample(), self.mesh.size,
                                              self.dp_size)
        # the wedged-device detector (runtime/watchdog.py), armed by the
        # first step's poke so that the first step's kernel builds cannot
        # trip it; under data parallelism an abort is agreed by every rank
        on_trip = (self._on_watchdog_abort
                   if self.distributed and cfg.watchdog_action == "abort" else None)
        watchdog = self.watchdog = (
            StepWatchdog(cfg.watchdog_timeout_s, cfg.watchdog_action, on_trip=on_trip,
                         start_paused=True)
            if cfg.watchdog_timeout_s > 0 else None)
        # replicas that should be equal, checked every desync_check_steps
        # (and once before the first step)
        desync = self.desync = DesyncMonitor(cfg.desync_check_steps)
        if self.distributed:
            desync.maybe_check(resumed_step, self.state.trainable, self.shards, self.tensor,
                               self.mesh)
        self.detector = self._start_detector()
        prev_sigterm = self._install_sigterm()
        self.telemetry.update(total_steps=self.total_steps, epochs=cfg.epochs,
                              step=resumed_step, state="training")
        t_start = time.perf_counter()
        step = self.state.step
        history_path = os.path.join(cfg.output_dir, "training_history.json")
        try:
            for epoch in range(start_epoch, cfg.epochs):
                batches = self.loader.global_epoch(epoch)
                if epoch == start_epoch and skip_batches:
                    batches = itertools.islice(batches, skip_batches, None)
                for full in batches:
                    # this rank's columns; the global microbatches' token
                    # counts are the loss's denominators under data parallelism
                    dev_batch = self._device_batch(self.loader.local_rows(full))
                    tokens = self._loss_tokens(full) if self.distributed else None
                    args = (self.state, dev_batch) + (() if tokens is None else (tokens,))
                    t_step = time.perf_counter()
                    self.state, metrics = self.train_step(*args)
                    self._sync()
                    step += 1
                    meter.update(samples_per_step, self._real_tokens(full),
                                 time.perf_counter() - t_step)
                    if watchdog is not None:
                        watchdog.poke(step)
                    if self._step_boundary(step):
                        # stop here, where (params, moments, step) agree
                        preempted = True
                        break
                    if self.distributed:
                        desync.maybe_check(step, self.state.trainable, self.shards, self.tensor,
                                           self.mesh)
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
                        if agree([self._better(last_eval, best_eval)], self.device)[0]:
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
                    if (do_eval or do_save) and self.primary:
                        # crash-safe history at every eval/checkpoint boundary
                        self.metrics.save_history(history_path)
                if preempted:
                    break
        finally:
            if watchdog is not None:
                # the end of the run (final eval, saves) has no step pokes
                watchdog.stop()
            if self.detector is not None:
                self.detector.stop()
            if prev_sigterm is not None:
                signal.signal(signal.SIGTERM, prev_sigterm)

        if preempted:
            # the emergency checkpoint, then out: the restarted run resumes
            # from here and finishes the eval, the best model and the export
            if self._saved_step != step:
                self._ckpt_save(ckpt, step, self._metric(last_eval))
            ckpt.close()
            print0(f"[train] preempted at step {step}: emergency checkpoint saved; exiting "
                   "cleanly for restart+resume", flush=True)
            self.telemetry.update(state="preempted", step=step)
            self.telemetry.recorder.record("emergency_checkpoint", step=step)
            if self.primary:
                self.metrics.save_history(history_path)
            barrier(self.device)
            return {"preempted": True, "step": step, "final_train_loss": final_loss,
                    "final_eval_loss": last_eval,
                    "wall_clock_seconds": time.perf_counter() - t_start}

        # a final eval when none ran, or when checkpoint-mode selection would
        # otherwise credit the final weights with an older eval
        final_eval_stale = (cfg.load_best_model_at_end and best_mode == "checkpoint"
                            and cfg.eval_steps and step % cfg.eval_steps != 0)
        if (last_eval is None or final_eval_stale) and self.n_val > 0:
            last_eval = self.evaluate()
            if cfg.load_best_model_at_end and agree([self._better(last_eval, best_eval)],
                                                    self.device)[0]:
                best_eval = last_eval
                best_trainable = None  # the current weights are the best
        self._ckpt_save(ckpt, step, self._metric(last_eval))
        ckpt.wait()
        if cfg.load_best_model_at_end and best_trainable is not None:
            with torch.no_grad():
                for k, v in self.state.trainable.items():
                    v.copy_(best_trainable[k])
        elif cfg.load_best_model_at_end and best_mode == "checkpoint":
            # the best saved checkpoint (rank 0's pick, once its saves are
            # written), read back only when it is not the final step's
            bstep = broadcast_int(ckpt.best_step if self.primary else None, self.device)
            if bstep is not None and bstep != step:
                best = self._restore(ckpt, bstep)
                with torch.no_grad():
                    for k, v in self.state.trainable.items():
                        v.copy_(best.trainable[k])
                print0(f"Restored best checkpoint step {bstep} ({cfg.metric_for_best_model} "
                       "tracking, best_model_tracking=checkpoint)")
        ckpt.close()
        self.last_checkpoint = ckpt.last_save
        self._sync()
        wall = time.perf_counter() - t_start
        self.telemetry.update(state="completed", step=step)
        summary = self._save_artifacts(final_loss, last_eval, wall, meter.snapshot())
        barrier(self.device)  # every rank returns once rank 0 has written
        return summary

    def _save_artifacts(self, final_loss, eval_loss, wall_seconds: float,
                        throughput: Dict[str, float]) -> Dict[str, Any]:
        """``best_model/`` (bf16 safetensors, tokenizer, config.json),
        ``training_history.json`` and ``training_summary.json`` with the
        reference keys, written by rank 0; every rank returns the summary."""
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
            "world_size": self.mesh.size,
            "distributed_training": self.mesh.size > 1,
            "final_eval_loss": eval_loss,
            "mesh": dict(self.mesh.shape),
            "wall_clock_seconds": round(wall_seconds, 2),
            "device": (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu"),
            **{k: round(v, 4) for k, v in throughput.items()},
        }
        if self.device.type == "cuda":
            summary["device_peak_bytes_in_use"] = torch.cuda.max_memory_allocated(self.device)
        # gathered on every rank, kept by rank 0 only
        trainable = self._full_trainable(self.primary)
        frozen = self._whole(self.state.frozen, self.primary)
        if not self.primary:
            return summary
        best_dir = os.path.join(cfg.output_dir, "best_model")
        params = {k: v.detach() for k, v in merge_flat(trainable, frozen).items()}
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
        print0(f"Best model saved to {best_dir}")
        self.metrics.save_history(os.path.join(cfg.output_dir, "training_history.json"))
        with open(os.path.join(cfg.output_dir, "training_summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        return summary
