"""The port's golden-question eval (``infer/golden.py`` and
``python -m llm_fine_tune_distributed_tpu_torch.eval_golden``) against the
JAX package's, on the ``tiny`` preset in f32 on the CPU: the mirror of
``tests/test_golden.py``, ``run_golden_eval`` answers equal to the JAX
``run_golden_eval`` on the same weights, the tuned-only report equal to the
JAX CLI's (the root ``eval_golden.py``) on the same model directory, and
the comparison report equal to the one the JAX CLI builds from the same
weights.

The weights' kernels are scaled x10 (at the 0.02 init the tied tiny model
answers every chat prompt with an empty reply).
"""

import json
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch import eval_golden
from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer import golden
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator
from llm_fine_tune_distributed_tpu_torch.infer.golden import (
    GOLDEN_QUESTIONS,
    GoldenAnswer,
    compare_golden,
    run_golden_eval,
    save_report,
)

ROOT = Path(__file__).resolve().parent.parent
MAX_NEW = 6


def _jax_params(seed):
    import jax
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.models.configs import get_preset
    from llm_fine_tune_distributed_tpu.models.transformer import init_params

    mc = get_preset("tiny")
    params = init_params(jax.random.PRNGKey(seed), mc, dtype=jnp.float32)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 10.0 if path[-1].key == "kernel" else x, params)
    return jax.device_get(params), mc


@pytest.fixture(scope="module")
def generators():
    """seed -> (the JAX Generator, the port's Generator) on the same x10
    weights, both in f32."""
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer as JaxTok
    from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator
    from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax
    from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset

    out = {}
    for seed in (0, 1):
        jparams, jmc = _jax_params(seed)
        flat = {k: np.asarray(v) for k, v in flatten_tree(jparams).items()}
        mc = get_preset("tiny")
        out[seed] = (JaxGenerator(jparams, jmc, JaxTok(), compute_dtype=jnp.float32),
                     Generator(params_from_jax(flat, mc), mc, ByteChatMLTokenizer(),
                               compute_dtype=torch.float32, device="cpu"))
    return out


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """Two tiny model directories (seeds 0 and 1) written by the JAX
    package."""
    from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer as JaxTok
    from llm_fine_tune_distributed_tpu.models import configs as jax_configs
    from llm_fine_tune_distributed_tpu.models.hf_io import save_hf_checkpoint

    dirs = []
    for seed in (0, 1):
        path = tmp_path_factory.mktemp(f"model{seed}")
        params, mc = _jax_params(seed)
        save_hf_checkpoint(params, str(path))
        with open(path / "config.json", "w") as f:
            json.dump(jax_configs.to_hf_dict(mc), f)
        JaxTok().save_pretrained(str(path))
        dirs.append(str(path))
    return dirs


def test_golden_questions_are_the_reference_five():
    from llm_fine_tune_distributed_tpu.infer import golden as jax_golden

    # the exact "Good Questions for Testing", reference README.md:15-21
    assert GOLDEN_QUESTIONS == [
        "How many cups in a gallon?",
        "How do I treat a nosebleed?",
        "What are the advantages of a mirrorless DSLR camera?",
        "What is the easiest loop knot to tie?",
        "I have a whistle, what is the right way to signal for help?",
    ]
    assert GOLDEN_QUESTIONS == jax_golden.GOLDEN_QUESTIONS
    assert golden.WILDERNESS_QUESTIONS == jax_golden.WILDERNESS_QUESTIONS


def test_run_and_compare(generators, tmp_path):
    tuned = run_golden_eval(generators[0][1], questions=GOLDEN_QUESTIONS[:2],
                            max_new_tokens=MAX_NEW)
    assert len(tuned) == 2
    assert all(a.n_chars == len(a.answer) for a in tuned)
    assert all(a.question in GOLDEN_QUESTIONS for a in tuned)
    report = compare_golden(tuned, tuned)
    assert report["n_questions"] == 2 and report["n_answers_differ"] == 0
    save_report(report, str(tmp_path / "r.json"))
    assert json.loads((tmp_path / "r.json").read_text()) == report


def test_compare_flags_divergence():
    from llm_fine_tune_distributed_tpu.infer import golden as jax_golden

    a = [GoldenAnswer("q1", "tuned answer", 2, 12), GoldenAnswer("q2", "same", 1, 4)]
    b = [GoldenAnswer("q1", "base answer", 2, 11), GoldenAnswer("q2", "same", 1, 4)]
    report = compare_golden(a, b)
    assert report["n_answers_differ"] == 1
    assert report["rows"][0]["answers_differ"] is True
    assert report["rows"][1]["answers_differ"] is False
    ja = [jax_golden.GoldenAnswer(**asdict(x)) for x in a]
    jb = [jax_golden.GoldenAnswer(**asdict(x)) for x in b]
    assert report == jax_golden.compare_golden(ja, jb)


def test_same_model_answers_identical(generators):
    gen = generators[0][1]
    a = run_golden_eval(gen, questions=GOLDEN_QUESTIONS[:1], max_new_tokens=MAX_NEW)
    b = run_golden_eval(gen, questions=GOLDEN_QUESTIONS[:1], max_new_tokens=MAX_NEW)
    assert compare_golden(a, b)["n_answers_differ"] == 0


@pytest.fixture(scope="module")
def jax_answers(generators):
    """The JAX ``run_golden_eval`` of the five golden questions on both
    seeds: seed 0 as a "tuned" model, seed 1 as an "original" one, asked
    with ``enable_thinking=False`` as the CLI asks it."""
    from llm_fine_tune_distributed_tpu.infer import golden as jax_golden

    return {seed: jax_golden.run_golden_eval(jgen, max_new_tokens=MAX_NEW, **_kw(seed))
            for seed, (jgen, _) in generators.items()}


def _kw(seed):
    return {"template_kwargs": {"enable_thinking": False}} if seed else {}


def test_run_golden_eval_equals_the_jax_answers(generators, jax_answers):
    """The five golden questions, greedy, on both packages with the same
    weights: the same answers and counts, for the "tuned" and the
    "original" model; the two differ."""
    got = {seed: [asdict(a) for a in run_golden_eval(gen, max_new_tokens=MAX_NEW, **_kw(seed))]
           for seed, (_, gen) in generators.items()}
    assert got == {seed: [asdict(a) for a in answers] for seed, answers in jax_answers.items()}
    assert all(a["answer"] for a in got[0])
    assert compare_golden([GoldenAnswer(**a) for a in got[0]],
                          [GoldenAnswer(**a) for a in got[1]])["n_answers_differ"] > 0


def _jax_cli(monkeypatch, argv):
    """The root ``eval_golden.py`` of the JAX package, its Generators in f32
    (the JAX CLI computes in its Generator's default bf16; the port on the
    CPU computes in f32)."""
    import functools

    import jax.numpy as jnp

    import llm_fine_tune_distributed_tpu.infer as jax_infer

    monkeypatch.setattr(jax_infer, "Generator",
                        functools.partial(jax_infer.Generator, compute_dtype=jnp.float32))
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("eval_golden", None)
    import eval_golden as jax_eval_golden

    return jax_eval_golden.main(argv)


def test_cli_tuned_only_report_equals_the_jax_clis(model_dirs, tmp_path, monkeypatch, capsys):
    """Tuned-only mode: ``{"mode": "tuned-only", "tuned_dir", "answers"}``
    with five answers, equal to the JAX CLI's report."""
    reports = {}
    for name in ("port", "jax"):
        path = tmp_path / f"{name}.json"
        argv = ["--tuned-dir", model_dirs[0], "--max-new-tokens", str(MAX_NEW),
                "--report", str(path)]
        rc = (eval_golden.main(argv + ["--device", "cpu"]) if name == "port"
              else _jax_cli(monkeypatch, argv))
        assert rc == 0
        reports[name] = json.loads(path.read_text())
    assert reports["port"] == reports["jax"]
    assert reports["port"]["mode"] == "tuned-only"
    assert len(reports["port"]["answers"]) == 5
    assert all(a["question"] and a["answer"] for a in reports["port"]["answers"])
    assert "Report written to" in capsys.readouterr().out


def test_cli_comparison_report_equals_the_jax_report(model_dirs, jax_answers, tmp_path):
    """Tuned and original: the side-by-side report (the original model's
    template with ``enable_thinking=False``) equals what the JAX CLI writes
    for the same weights, ``compare_golden`` over the JAX package's answers
    of both models."""
    from llm_fine_tune_distributed_tpu.infer import golden as jax_golden

    path = tmp_path / "report.json"
    assert eval_golden.main(["--tuned-dir", model_dirs[0], "--original-dir", model_dirs[1],
                             "--max-new-tokens", str(MAX_NEW), "--report", str(path),
                             "--device", "cpu"]) == 0
    report = json.loads(path.read_text())
    assert report == json.loads(json.dumps(jax_golden.compare_golden(jax_answers[0],
                                                                     jax_answers[1])))
    assert report["n_questions"] == 5 and report["n_answers_differ"] > 0


def test_cli_refuses_a_missing_directory_and_a_missing_gpu(tmp_path, capsys):
    assert eval_golden.main(["--tuned-dir", str(tmp_path / "nope"), "--device", "cpu"]) == 1
    assert "model directory not found" in capsys.readouterr().out
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit) as exc:
        eval_golden.main(["--tuned-dir", str(tmp_path)])
    assert exc.value.code == 2 and "no CUDA device" in capsys.readouterr().err
