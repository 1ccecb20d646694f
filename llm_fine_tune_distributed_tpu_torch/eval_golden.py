"""Golden-question eval CLI: the reference's manual five-question
tuned-versus-original comparison as a program (counterpart of the JAX
package's root ``eval_golden.py``, with the same flags plus ``--device``).

Usage:
  python -m llm_fine_tune_distributed_tpu_torch.eval_golden --tuned-dir outputs/best_model \\
      [--original-dir <base model dir>] [--report golden_report.json] \\
      [--max-new-tokens 256] [--question-set golden|wilderness|both] [--device cuda|cpu]

With only --tuned-dir it answers the questions with the tuned model and
writes ``{"mode": "tuned-only", ...}``. With both directories it prints the
side-by-side report and writes it as JSON; the original model's chat
template gets ``enable_thinking=False``, as the reference passes it. It runs
on the GPU (bf16) unless ``--device cpu`` is given (f32).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--tuned-dir", default=os.environ.get("MODEL_DIR", "outputs/best_model"))
    parser.add_argument("--original-dir", default=None)
    parser.add_argument("--report", default="golden_report.json")
    parser.add_argument("--max-new-tokens", type=int, default=256)
    parser.add_argument("--question-set", choices=["golden", "wilderness", "both"],
                        default="golden",
                        help="golden = the reference's five (README.md:15-21); wilderness = "
                             "extra domain smoke set; both = concatenation")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default, bf16) or cpu (f32)")
    args = parser.parse_args(argv)

    import torch

    from llm_fine_tune_distributed_tpu_torch.device import resolve_device
    from llm_fine_tune_distributed_tpu_torch.infer.generate import (
        Generator,
        load_model_dir,
        load_tokenizer_dir,
    )
    from llm_fine_tune_distributed_tpu_torch.infer.golden import (
        GOLDEN_QUESTIONS,
        WILDERNESS_QUESTIONS,
        compare_golden,
        print_report,
        run_golden_eval,
        save_report,
    )

    questions = {"golden": GOLDEN_QUESTIONS, "wilderness": WILDERNESS_QUESTIONS,
                 "both": GOLDEN_QUESTIONS + WILDERNESS_QUESTIONS}[args.question_set]
    if not os.path.isdir(args.tuned_dir):
        print(f"Error: model directory not found: {args.tuned_dir!r}")
        return 1
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.exit(2, f"error: {e}\n")
    compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    def make_generator(path):
        params, mc = load_model_dir(path, device=device, dtype=compute_dtype)
        return Generator(params, mc, load_tokenizer_dir(path), compute_dtype=compute_dtype,
                         device=device)

    print(f"Evaluating tuned model: {args.tuned_dir}")
    tuned = run_golden_eval(make_generator(args.tuned_dir), questions=questions,
                            max_new_tokens=args.max_new_tokens)
    if args.original_dir is None:
        for a in tuned:
            print("=" * 72)
            print(f"Q: {a.question}\nA: {a.answer[:400]}")
        if args.report:
            # one model still leaves an artifact (the tuned answers) for a run report
            with open(args.report, "w") as f:
                json.dump({"mode": "tuned-only", "tuned_dir": args.tuned_dir,
                           "answers": [{"question": a.question, "answer": a.answer}
                                       for a in tuned]}, f, indent=2)
            print(f"Report written to {args.report}")
        return 0

    print(f"Evaluating original model: {args.original_dir}")
    original = run_golden_eval(make_generator(args.original_dir), questions=questions,
                               max_new_tokens=args.max_new_tokens,
                               # the reference passes enable_thinking=False to
                               # the base model only (ask_original_model.py:44)
                               template_kwargs={"enable_thinking": False})
    report = compare_golden(tuned, original)
    print_report(report)
    save_report(report, args.report)
    print(f"Report written to {args.report}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
