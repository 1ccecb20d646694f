"""PyTorch/CUDA port of ``llm_fine_tune_distributed_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's layout (``models/``, ``ops/``,
``infer/``, ``data/``) so every module has an obvious counterpart. It imports
``torch``, numpy and the standard library only: nothing of JAX and nothing of
the JAX package. What it needs from there is copied in.

Slice ported so far: paged int8-KV serving (``infer/server.py --engine paged
--quantize-kv int8``). Each decode step's attention runs through the
hand-written CUDA kernel in ``csrc/paged_decode.cu``
(``ops/flash_attention.paged_decode_attention``).
"""

from llm_fine_tune_distributed_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
