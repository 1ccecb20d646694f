"""PyTorch/CUDA port of ``llm_fine_tune_distributed_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's layout (``models/``, ``ops/``,
``infer/``, ``data/``, ``train/``, ``parallel/``, ``observe/``, ``utils/``)
so every module has an obvious counterpart. It imports
``torch``, numpy and the standard library only: nothing of JAX and nothing of
the JAX package. What it needs from there is copied in.

Slices ported so far:

- paged int8-KV serving (``infer/server.py --engine paged --quantize-kv
  int8``); each decode step's attention runs the hand-written CUDA kernel in
  ``csrc/paged_decode.cu`` (``ops/flash_attention.paged_decode_attention``);
- single-card SFT training (``cli.py``, ``train/trainer.SFTTrainer``); each
  attention forward runs ``csrc/flash_fwd.cu`` and each backward the dq and
  dk/dv kernels of ``csrc/flash_bwd.cu`` (``ops/flash_attention.flash_attention``).
"""

from llm_fine_tune_distributed_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
