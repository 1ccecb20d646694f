"""Entry points of the port (counterparts of the JAX ``cli.py``):
``train_main`` (``python -m llm_fine_tune_distributed_tpu_torch.cli``),
``ask_main`` (ask the tuned model a question) and ``serve_main`` (serve it
over HTTP).

The env-var contract is the JAX package's (EPOCHS, BATCH_SIZE,
LEARNING_RATE, DATA_DIR, OUTPUT_DIR, MODEL_PRESET, MODEL_NAME,
TOKENIZER_PATH, MAX_SEQ_LENGTH, GRAD_ACCUM_STEPS, SEED, ...; see
``config.TrainConfig._ENV_MAP``). Training runs on the GPU unless
``--device cpu`` is given; without a GPU it exits non-zero.

Data-parallel training takes the launcher's env (``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; ``torchrun`` and the
Kubeflow PyTorchJob set them) and the mesh from ``MESH_DATA`` /
``MESH_FSDP`` (by default fsdp takes every rank): for example
``python -m torch.distributed.run --nproc-per-node 2 -m
llm_fine_tune_distributed_tpu_torch.cli --device cpu`` trains over two gloo
processes on the CPU, and without ``--device`` over NCCL, one GPU per
process. Rank 0 alone prints the banner and the result.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional


def train_main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        description="SFT or DPO fine-tuning on NVIDIA GPUs, one per process")
    parser.add_argument("--config", help="JSON TrainConfig file")
    parser.add_argument("--model-preset", help="model preset override")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu (the kernels' plain versions)")
    args = parser.parse_args(argv)

    import torch

    from llm_fine_tune_distributed_tpu_torch.config import MeshConfig, TrainConfig
    from llm_fine_tune_distributed_tpu_torch.device import resolve_device
    from llm_fine_tune_distributed_tpu_torch.runtime import distributed

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"train: {e}", file=sys.stderr)
        return 2
    # the process group of a launcher's env (a no-op for one process); a
    # group the caller made before is the caller's to end
    made_here = not distributed.is_distributed()
    distributed.initialize_distributed(device=device)
    distributed.device_preflight(device)
    if device.type == "cuda" and distributed.is_distributed():
        device = torch.device("cuda", torch.cuda.current_device())
    primary = distributed.is_primary_host()  # kept past the group's end

    def print0(*a, **kw):
        if primary:
            print(*a, **kw)

    config = TrainConfig.load(args.config) if args.config else TrainConfig()
    config.apply_env_overrides()
    if args.model_preset:
        config.model_preset = args.model_preset
    mesh_env = {k: os.environ.get(f"MESH_{k.upper()}")
                for k in ("data", "fsdp", "tensor", "seq", "expert", "pipe")}
    if any(v is not None for v in mesh_env.values()):
        config.mesh = MeshConfig(**{k: int(v) for k, v in mesh_env.items() if v is not None})

    if config.objective not in ("sft", "dpo"):
        print(f"train: unknown OBJECTIVE {config.objective!r}; expected 'sft' or 'dpo'",
              file=sys.stderr)
        return 2
    print0("=" * 60)
    print0(f"{config.objective.upper()} on {device}"
           + (f" x {distributed.process_count()} processes" if distributed.is_distributed()
              else ""))
    print0(f"  epochs={config.epochs} batch={config.per_device_batch_size} "
           f"lr={config.learning_rate} accum={config.gradient_accumulation_steps}")
    print0(f"  data={config.data_dir} output={config.output_dir}")
    print0("=" * 60)

    if config.objective == "dpo":
        # preference pairs (OBJECTIVE=dpo), as the JAX entry point routes them
        from llm_fine_tune_distributed_tpu_torch.train.dpo import DPOTrainer as Trainer
    else:
        from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer as Trainer

    try:
        summary = Trainer(config, device=device).train()
    finally:
        if made_here:
            distributed.destroy()
    print0("\nQ&A fine-tuning completed successfully!")
    print0(f"Training artifacts saved to {config.output_dir}/")
    print0(f"samples/sec/card: {summary.get('samples_per_second_per_chip')}")
    return 0


def ask_main(argv: Optional[list] = None) -> int:
    """Ask the fine-tuned model a question (the reference's ask_tuned_model.py)."""
    from llm_fine_tune_distributed_tpu_torch.infer.cli import run_ask_cli

    return run_ask_cli(
        argv,
        description=ask_main.__doc__,
        default_model_dir="outputs/best_model",
        model_dir_env="MODEL_DIR",
        missing_dir_help="Run training first (python -m llm_fine_tune_distributed_tpu_torch.cli) "
                         "or pass --model-dir.",
    )


def serve_main(argv: Optional[list] = None) -> int:
    """Serve the tuned model over HTTP (infer/server.py)."""
    from llm_fine_tune_distributed_tpu_torch.infer.server import main

    return main(argv)


if __name__ == "__main__":
    sys.exit(train_main())
