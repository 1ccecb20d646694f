"""Training configuration (counterpart of the JAX ``config.py``).

``TrainConfig`` keeps the JAX package's field names and defaults for the
fields the port's SFT trainer reads, so a JSON config written for one loads
in the other. Two defaults differ, on purpose:

- ``dataset_file`` is ``final_qa_data_unique.jsonl``: the card's machine has
  no ``pyarrow``, and the JSONL holds the same rows as ``qa_dataset.parquet``
  (``data/dataset.load_qa_dataset``);
- ``use_native_loader`` is False: the JAX package's C++ loader draws another
  permutation than the Python loader, and the port has only the latter.

Knobs whose branches are not ported are kept so that setting them raises
(``train/trainer.check_supported``) instead of being ignored.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch


@dataclass
class MeshConfig:
    """Device mesh axis sizes over the ranks of the process group (one
    device each); -1 absorbs the remaining ranks. ``data`` and ``fsdp`` split
    the batch (``fsdp`` also shards the leaves and the AdamW state), ``tensor``
    the model's heads, MLP columns and vocab (``runtime/mesh.py``); the
    other axes must resolve to 1."""

    data: int = 1
    fsdp: int = -1
    tensor: int = 1
    seq: int = 1
    expert: int = 1
    pipe: int = 1

    def axis_sizes(self, n_devices: int) -> dict:
        sizes = dataclasses.asdict(self)
        unknown = [k for k, v in sizes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {unknown}")
        fixed = 1
        for v in sizes.values():
            if v != -1:
                fixed *= v
        if unknown:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {sizes}")
            sizes[unknown[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh {sizes} does not cover {n_devices} devices")
        return sizes


@dataclass
class TrainConfig:
    """SFT training configuration. Defaults reproduce the reference recipe:
    per-device batch 8, grad-accum 4, lr 5e-5 with linear decay, clip 1.0,
    log every 2 steps and the first, eval every 10, bf16 compute over f32
    trainable masters, seq 1024, last 2 layers plus the (tied) head
    trainable, 90/10 split with seed 42."""

    # model / data
    model_name: str = "HuggingFaceTB/SmolLM3-3B"
    model_preset: Optional[str] = "smollm3_3b"
    data_dir: str = "data"
    dataset_file: str = "final_qa_data_unique.jsonl"
    output_dir: str = "outputs"
    tokenizer_path: Optional[str] = None  # defaults to model_name
    # None = the wilderness-survival persona
    system_prompt: Optional[str] = None

    # optimization
    epochs: int = 4
    per_device_batch_size: int = 8
    gradient_accumulation_steps: int = 4
    learning_rate: float = 5e-5
    scale_lr_by_data_parallel: bool = True
    optimizer: str = "adamw"
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    warmup_ratio: float = 0.0
    lr_schedule: str = "linear"
    seed: int = 42

    # sequence / precision
    max_seq_length: int = 1024
    packing: bool = False
    param_dtype: str = "float32"     # trainable masters
    compute_dtype: str = "bfloat16"  # activations, matmuls, frozen weights
    gradient_checkpointing: bool = True
    # None = auto (resolved_remat_policy)
    remat_policy: Optional[str] = None
    completion_only_loss: bool = False
    loss_chunk_size: Optional[int] = None
    loss_vocab_chunk: Optional[int] = None

    # objective ("sft", or "dpo": preference pairs, train/dpo.py) and the
    # freezing policy ("last_n_and_head", "none", "lora", "qlora")
    objective: str = "sft"
    dpo_beta: float = 0.1              # TRL DPOConfig default
    dpo_label_smoothing: float = 0.0   # conservative-DPO eps
    freeze_strategy: str = "last_n_and_head"
    unfreeze_last_n_layers: int = 2
    frozen_compute: str = "bf16"

    # QLoRA (freeze_strategy="qlora"): the NF4 frozen base (ops/nf4.py)
    quant_block_size: int = 64
    quant_double_quant: bool = True

    # LoRA (the reference's article: r 16, alpha 8, dropout 0.05, 7 targets)
    lora_rank: int = 16
    lora_alpha: float = 8.0
    lora_dropout: float = 0.05        # recorded in adapter_config.json, not applied
    lora_target_modules: Sequence[str] = (
        "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
    )

    # cadence and best-model tracking
    logging_steps: int = 2
    logging_first_step: bool = True
    eval_steps: int = 10
    eval_batch_size: Optional[int] = None
    save_steps: int = 500
    save_total_limit: int = 3
    metric_for_best_model: str = "eval_loss"
    greater_is_better: bool = False
    load_best_model_at_end: bool = True
    best_model_tracking: str = "auto"

    # data split / loader
    validation_fraction: float = 0.1
    split_seed: int = 42
    drop_last: bool = True
    use_native_loader: bool = False

    # mesh / attention
    mesh: MeshConfig = field(default_factory=MeshConfig)
    attention_impl: str = "flash"

    # step watchdog (runtime/watchdog.py): seconds without an optimizer
    # step before reporting a wedged device (0 = off); "abort" ends the
    # process with os._exit for the job manager to restart it
    watchdog_timeout_s: float = 0.0
    watchdog_action: str = "warn"

    # checkpoints (train/checkpoints.py): a trainable-only payload (the
    # frozen leaves rebuilt and fingerprint-verified at resume), and the
    # save as an on-device snapshot written on a background thread
    checkpoint_trainable_only: bool = False
    checkpoint_async_snapshot: bool = True
    resume_from_checkpoint: Optional[str] = None

    # live deployment (train/publish.py): after each save, the trainable
    # weights and a manifest go to publish_dir, newest publish_keep_last
    # kept; publish_require_clean skips a publish whose trailing
    # anomaly_window_steps window saw a sentinel fire (observe/trainplane.py)
    publish_dir: Optional[str] = None
    publish_keep_last: int = 3
    publish_require_clean: bool = False
    anomaly_window_steps: int = 100
    anomaly_band_sigma: float = 6.0

    # multi-process runs (runtime/desync.py): a cross-rank checksum of the
    # trainable leaves every N steps (0 = off); the heartbeat failure
    # detector is not ported (True raises)
    heartbeat: bool = False
    heartbeat_port: int = 23457
    heartbeat_timeout_ms: int = 30000
    desync_check_steps: int = 0

    # not ported: setting it raises
    train_port: Optional[int] = None

    def effective_batch_size(self, data_parallel_size: int) -> int:
        return self.per_device_batch_size * self.gradient_accumulation_steps * data_parallel_size

    def resolved_remat_policy(self, model_config, seq_parallel_size: int = 1) -> str:
        """``remat_policy=None`` ("auto") by model size and per-device
        sequence length, the JAX package's rule: "full" from 6B parameters
        or seq >= 8192, "mlp" at seq >= 4096, else "dots_no_batch". An
        explicit setting always wins."""
        if self.remat_policy is not None:
            return self.remat_policy
        if model_config.num_params >= 6e9:
            return "full"
        per_device_seq = self.max_seq_length // max(seq_parallel_size, 1)
        if per_device_seq >= 8192:
            return "full"
        return "mlp" if per_device_seq >= 4096 else "dots_no_batch"

    def scaled_learning_rate(self, data_parallel_size: int) -> float:
        if self.scale_lr_by_data_parallel:
            return self.learning_rate * data_parallel_size
        return self.learning_rate

    # ---- env-var override surface (the JAX package's names)

    _ENV_MAP = {
        "EPOCHS": ("epochs", int),
        "BATCH_SIZE": ("per_device_batch_size", int),
        "LEARNING_RATE": ("learning_rate", float),
        "DATA_DIR": ("data_dir", str),
        "OUTPUT_DIR": ("output_dir", str),
        "MODEL_NAME": ("model_name", str),
        "MODEL_PRESET": ("model_preset", lambda s: None if s.lower() == "none" else s),
        "TOKENIZER_PATH": ("tokenizer_path", str),
        "MAX_SEQ_LENGTH": ("max_seq_length", int),
        "GRAD_ACCUM_STEPS": ("gradient_accumulation_steps", int),
        "SEED": ("seed", int),
        "ATTENTION_IMPL": ("attention_impl", str),
        "OPTIMIZER": ("optimizer", str),
        "PARAM_DTYPE": ("param_dtype", str),
        "FREEZE_STRATEGY": ("freeze_strategy", str),
        "FROZEN_COMPUTE": ("frozen_compute", str),
        "REMAT_POLICY": ("remat_policy", str),
        "LOSS_CHUNK_SIZE": ("loss_chunk_size", int),
        "LOSS_VOCAB_CHUNK": ("loss_vocab_chunk", int),
        "RESUME_FROM_CHECKPOINT": ("resume_from_checkpoint", str),
        "CHECKPOINT_TRAINABLE_ONLY": ("checkpoint_trainable_only", "_env_bool"),
        "CHECKPOINT_ASYNC_SNAPSHOT": ("checkpoint_async_snapshot", "_env_bool"),
        "PUBLISH_DIR": ("publish_dir", str),
        "PUBLISH_KEEP_LAST": ("publish_keep_last", int),
        "PUBLISH_REQUIRE_CLEAN": ("publish_require_clean", "_env_bool"),
        "ANOMALY_WINDOW_STEPS": ("anomaly_window_steps", int),
        "ANOMALY_BAND_SIGMA": ("anomaly_band_sigma", float),
        "TRAIN_PORT": ("train_port", int),
        "OBJECTIVE": ("objective", str),
        "DPO_BETA": ("dpo_beta", float),
        "LOGGING_STEPS": ("logging_steps", int),
        "EVAL_STEPS": ("eval_steps", int),
        "EVAL_BATCH_SIZE": ("eval_batch_size", int),
        "SAVE_STEPS": ("save_steps", int),
        "SAVE_TOTAL_LIMIT": ("save_total_limit", int),
        "WATCHDOG_TIMEOUT_S": ("watchdog_timeout_s", float),
        "WATCHDOG_ACTION": ("watchdog_action", str),
    }
    # env vars of the JAX package whose features are not ported: set, they raise
    _UNPORTED_ENV = ("AIM_REPO", "EXPERIMENT_NAME")

    @staticmethod
    def _env_bool(s: str) -> bool:
        v = s.strip().lower()
        if v in ("1", "true", "yes", "on"):
            return True
        if v in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"boolean env var must be 1/0/true/false/yes/no/on/off, got {s!r}")

    def apply_env_overrides(self, environ=None) -> "TrainConfig":
        env = os.environ if environ is None else environ
        unported = [v for v in self._UNPORTED_ENV if env.get(v)]
        if unported:
            raise NotImplementedError(
                f"env {', '.join(unported)}: not ported to the PyTorch trainer "
                "(llm_fine_tune_distributed_tpu.config.TrainConfig.apply_env_overrides has them)"
            )
        for var, (attr, cast) in self._ENV_MAP.items():
            if env.get(var):
                if cast == "_env_bool":
                    cast = self._env_bool
                setattr(self, attr, cast(env[var]))
        return self

    # ---- (de)serialization

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["lora_target_modules"] = list(self.lora_target_modules)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        d = dict(d)
        if isinstance(d.get("mesh"), dict):
            d["mesh"] = MeshConfig(**d["mesh"])
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"config keys {sorted(unknown)} are unknown or not ported to the PyTorch "
                "trainer (llm_fine_tune_distributed_tpu.config.TrainConfig has the full set)"
            )
        return cls(**d)

    @classmethod
    def load(cls, path: str) -> "TrainConfig":
        """Load a JSON config file."""
        if path.endswith((".yaml", ".yml")):
            raise NotImplementedError(
                "YAML configs are not ported (the JAX package reads them with pyyaml); use JSON"
            )
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


def str_to_dtype(name: str) -> torch.dtype:
    return {
        "float32": torch.float32,
        "f32": torch.float32,
        "bfloat16": torch.bfloat16,
        "bf16": torch.bfloat16,
        "float16": torch.float16,
    }[name]
