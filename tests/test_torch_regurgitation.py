"""Decode agrees with training, through the port (the mirror of
``tests/test_regurgitation.py``): a ``tiny`` model that the port's trainer
overfits on 20 QA pairs to a near-zero teacher-forced loss must repeat the
training answers under greedy ``Generator.chat`` through the ``best_model/``
directory it exported. A mismatch in the chat template, positions or the
tokenizer between training and decode shows here.

It trains 1350 steps on the CPU (about 50 s), so it is marked ``slow``, as
the JAX test is.
"""

import difflib
import json

import numpy as np
import pytest
import torch

SYS = "Be brief."
_WORDS = [
    "river", "stone", "papaya", "gallon", "maple", "knot", "ember", "cliff",
    "lantern", "moss", "falcon", "cedar", "pearl", "quartz", "willow",
    "ridge", "fern", "slate", "harbor", "thistle",
]
# distinct, low-interference answers: one unique lead word per item
ANSWERS = [f"item {i} is {_WORDS[i]} {_WORDS[(i + 7) % 20]}." for i in range(20)]


@pytest.fixture(scope="module")
def memorized(tmp_path_factory):
    """Overfit tiny on 20 QA pairs (JSONL, the port's dataset format) with
    the JAX test's recipe on one CPU device, f32."""
    from llm_fine_tune_distributed_tpu_torch.config import TrainConfig
    from llm_fine_tune_distributed_tpu_torch.data.dataset import (
        load_qa_dataset,
        train_validation_split,
    )
    from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

    tmp = tmp_path_factory.mktemp("regurg")
    with open(tmp / "qa.jsonl", "w") as f:
        for i, a in enumerate(ANSWERS):
            f.write(json.dumps({"topic": "Memory", "question": f"what is item {i}?",
                                "answer": a}) + "\n")
    cfg = TrainConfig(
        model_name="tiny-random", model_preset="tiny", tokenizer_path="byte-chatml",
        system_prompt=SYS, data_dir=str(tmp), dataset_file="qa.jsonl",
        output_dir=str(tmp / "out"), epochs=150, per_device_batch_size=2,
        gradient_accumulation_steps=1, learning_rate=2e-3,
        lr_schedule="cosine",  # settles to 0 so the memorization sticks
        warmup_ratio=0.02,
        # loss on the answer bytes only: the full-sequence loss carries the
        # irreducible entropy of the item number inside the prompt
        completion_only_loss=True, max_seq_length=160,
        freeze_strategy="none",  # memorization needs full capacity
        validation_fraction=0.1,  # 18 train / 2 validation
        eval_steps=0, logging_steps=50, save_steps=0, gradient_checkpointing=False,
        compute_dtype="float32",
    )
    summary = SFTTrainer(cfg, device="cpu").train()
    # the premise: the teacher-forced loss is ~0
    assert summary["final_train_loss"] < 0.02, summary["final_train_loss"]
    # regurgitation is a claim about the training rows: the trainer's split
    # and the "For {topic}, {question}" text it saw
    rows = load_qa_dataset(str(tmp / "qa.jsonl"))
    train_rows, _ = train_validation_split(rows, test_size=cfg.validation_fraction,
                                           seed=cfg.split_seed)
    return str(tmp / "out" / "best_model"), [
        {"q": r["full-question"], "a": r["answer"]} for r in train_rows]


@pytest.mark.slow
def test_overfit_model_greedily_regurgitates_training_answers(memorized):
    from llm_fine_tune_distributed_tpu_torch.infer.generate import (
        Generator,
        load_model_dir,
        load_tokenizer_dir,
    )
    from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig

    best_dir, train_rows = memorized
    params, mc = load_model_dir(best_dir, device="cpu", dtype=torch.float32)
    gen = Generator(params, mc, load_tokenizer_dir(best_dir), compute_dtype=torch.float32,
                    device="cpu")
    overlaps, exact = [], 0
    for row in train_rows[:10]:
        got = gen.chat([{"role": "system", "content": SYS}, {"role": "user", "content": row["q"]}],
                       GenerationConfig(max_new_tokens=len(row["a"]) + 24, do_sample=False))
        overlaps.append(difflib.SequenceMatcher(None, got, row["a"]).ratio())
        exact += int(got.strip() == row["a"].strip())
    mean_overlap = float(np.mean(overlaps))
    assert mean_overlap > 0.9, (mean_overlap, overlaps)
    assert exact >= 7, (exact, overlaps)
