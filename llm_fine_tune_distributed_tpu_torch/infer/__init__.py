"""Generation and serving of the port: sampling, the generator (dense and
paged decode), block bookkeeping, the continuous batching engine, the ask
CLI and the HTTP server."""

from llm_fine_tune_distributed_tpu_torch.infer.generate import (
    Generator,
    load_model_dir,
    load_tokenizer_dir,
)
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig

__all__ = ["GenerationConfig", "Generator", "load_model_dir", "load_tokenizer_dir"]
