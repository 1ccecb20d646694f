"""Ask the fine-tuned model a question: loads the ``best_model/`` the
trainer wrote, builds the ChatML prompt with the wilderness system prompt
and samples with the reference's generation parameters.

Usage:
  python -m llm_fine_tune_distributed_tpu_torch.ask_tuned_model "How many cups are in a gallon?"
  python -m llm_fine_tune_distributed_tpu_torch.ask_tuned_model --device cpu \\
      --model-dir outputs/best_model "What knot for a tarp?"
"""

import sys

from llm_fine_tune_distributed_tpu_torch.cli import ask_main

if __name__ == "__main__":
    sys.exit(ask_main())
