"""Generation and serving of the port: sampling, the generator (dense and
paged decode), block bookkeeping and the host KV tier, the serving engines
(continuous, paged and window batching), the fleet of engine replicas and its
router, live deployment (the publish watcher and the hot-swap manager), the
ask CLI and the HTTP server."""

from llm_fine_tune_distributed_tpu_torch.infer.batching import BatchingEngine
from llm_fine_tune_distributed_tpu_torch.infer.deploy import CheckpointWatcher, HotSwapManager
from llm_fine_tune_distributed_tpu_torch.infer.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from llm_fine_tune_distributed_tpu_torch.infer.fleet import EngineFleet
from llm_fine_tune_distributed_tpu_torch.infer.generate import (
    Generator,
    load_model_dir,
    load_tokenizer_dir,
)
from llm_fine_tune_distributed_tpu_torch.infer.paged import HostBlockTier
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.observe.metrics import ServingStats

__all__ = ["BatchingEngine", "CheckpointWatcher", "ContinuousBatchingEngine", "EngineFleet",
           "GenerationConfig", "Generator", "HostBlockTier", "HotSwapManager",
           "PagedContinuousBatchingEngine", "ServingStats", "load_model_dir",
           "load_tokenizer_dir"]
