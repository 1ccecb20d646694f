"""Golden-question behavioural eval (counterpart of the JAX
``infer/golden.py``).

The reference checks a fine-tune by hand: it asks five canonical questions
to the tuned and to the original model under the same system prompt and
compares the answers (reference ``README.md:15-21``). This module makes that
a program: ``run_golden_eval`` answers a question set with one
``Generator``, ``compare_golden`` lines two runs up side by side, and
``save_report`` / ``print_report`` write the JSON and the text.

``GOLDEN_QUESTIONS`` are the reference's five, verbatim.
``WILDERNESS_QUESTIONS`` are extra questions of the dataset's own domain,
outside the reference's contract.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig

GOLDEN_QUESTIONS: List[str] = [
    # the reference's "Good Questions for Testing", README.md:15-21, verbatim
    "How many cups in a gallon?",
    "How do I treat a nosebleed?",
    "What are the advantages of a mirrorless DSLR camera?",
    "What is the easiest loop knot to tie?",
    "I have a whistle, what is the right way to signal for help?",
]

# extra questions of the dataset's headline domain (beyond the reference's five)
WILDERNESS_QUESTIONS: List[str] = [
    "What's the best way to purify water in the wilderness?",
    "How do I build an emergency shelter?",
    "What should I do if I encounter a bear?",
    "How do I start a fire without matches?",
]


@dataclass
class GoldenAnswer:
    question: str
    answer: str
    n_tokens: int
    n_chars: int


def run_golden_eval(
    generator,
    *,
    questions: Optional[List[str]] = None,
    max_new_tokens: int = 256,
    greedy: bool = True,
    system_prompt: Optional[str] = None,
    template_kwargs: Optional[dict] = None,
) -> List[GoldenAnswer]:
    """Answer every question with one Generator (``Generator.chat``, seed
    0); ``n_tokens`` counts the answer text's tokens."""
    cfg = GenerationConfig(max_new_tokens=max_new_tokens, do_sample=not greedy)
    out = []
    for q in questions or GOLDEN_QUESTIONS:
        messages = [
            {"role": "system", "content": system_prompt or WILDERNESS_EXPERT_SYSTEM_PROMPT},
            {"role": "user", "content": q},
        ]
        answer = generator.chat(messages, cfg, seed=0, **(template_kwargs or {}))
        out.append(GoldenAnswer(question=q, answer=answer,
                                n_tokens=len(generator.tokenizer.encode(answer)),
                                n_chars=len(answer)))
    return out


def compare_golden(tuned: List[GoldenAnswer], original: List[GoldenAnswer]) -> Dict[str, object]:
    """The side-by-side report. The answers must differ for the fine-tune
    to have had an effect: that divergence is what the reference checks by
    hand."""
    rows = []
    n_diff = 0
    for t, o in zip(tuned, original):
        differs = t.answer.strip() != o.answer.strip()
        n_diff += differs
        rows.append({"question": t.question, "tuned": asdict(t), "original": asdict(o),
                     "answers_differ": differs})
    return {"n_questions": len(rows), "n_answers_differ": n_diff, "rows": rows}


def save_report(report: Dict[str, object], path: str) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2)


def print_report(report: Dict[str, object], max_chars: int = 400) -> None:
    for row in report["rows"]:
        print("=" * 72)
        print(f"Q: {row['question']}")
        print(f"--- tuned ({row['tuned']['n_tokens']} tokens):")
        print(row["tuned"]["answer"][:max_chars])
        print(f"--- original ({row['original']['n_tokens']} tokens):")
        print(row["original"]["answer"][:max_chars])
    print("=" * 72)
    print(f"{report['n_answers_differ']}/{report['n_questions']} answers differ "
          "between tuned and original")
