"""The port's QLoRA shape-level planner (``parallel/qlora.
quantize_frozen_abstract``) against the JAX package's, on the CPU."""

import pytest
import torch


@pytest.mark.parametrize("block,double_quant", [(64, True), (64, False), (32, True)])
def test_quantize_frozen_abstract_is_the_jax_planner(block, double_quant):
    """The shape-level planner's leaves (names, shapes, dtypes) are the JAX
    ``quantize_frozen_abstract``'s over the same tree, and the real
    quantizer's."""
    import jax
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.parallel.qlora import (
        quantize_frozen_abstract as jax_abstract,
    )
    from llm_fine_tune_distributed_tpu_torch.parallel.qlora import (
        quantize_frozen,
        quantize_frozen_abstract,
    )

    shapes = {"model.layers.0.self_attn.q_proj.kernel": (64, 96),
              "model.layers.0.mlp.down_proj.kernel": (192, 64),
              "model.layers.0.mlp.up_proj.kernel": (96, 64),  # 96 % 64: kept whole at block 64
              "model.layers.0.input_layernorm.weight": (64,),
              "model.embed_tokens.weight": (128, 64)}
    got = quantize_frozen_abstract({k: torch.empty(v, device="meta") for k, v in shapes.items()},
                                   block, double_quant)
    want = jax_abstract({k.replace(".", "/"): jax.ShapeDtypeStruct(v, jnp.float32)
                         for k, v in shapes.items()}, block, double_quant)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in got.items()} == {
        k.replace("/", "."): (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    real = quantize_frozen({k: torch.randn(v) for k, v in shapes.items()}, block, double_quant)
    assert {k: (v.shape, v.dtype) for k, v in real.items()} == {
        k: (v.shape, v.dtype) for k, v in got.items()}
