"""Ask the original (not fine-tuned) base model the same question under the
same wilderness system prompt, for a before/after comparison. The chat
template gets ``enable_thinking=False``, as the reference passes it, since
SmolLM3 is a hybrid-reasoning model.

The base checkpoint is a local directory: pass --model-dir or set
BASE_MODEL_DIR.
"""

import sys

from llm_fine_tune_distributed_tpu_torch.infer.cli import run_ask_cli

if __name__ == "__main__":
    sys.exit(
        run_ask_cli(
            None,
            description=__doc__,
            default_model_dir="",
            model_dir_env="BASE_MODEL_DIR",
            missing_dir_help="Pass --model-dir /path/to/SmolLM3-3B or set BASE_MODEL_DIR.",
            template_kwargs={"enable_thinking": False},
        )
    )
