"""The port's ask CLI and entry points against the JAX package's, on a
tiny model directory on the CPU: the same ``Answer:`` line, greedy, with
and without weight-only int8 and NF4; every refused or unported flag stops
before a weight is loaded; without a GPU the default device exits non-zero;
the server takes ``--quantize int8`` and ``--quantize nf4`` and answers.

The JAX CLI computes in bf16 by default; here its Generator is given f32,
the port's compute dtype on the CPU, so that greedy tokens can be compared.
"""

import functools
import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import llm_fine_tune_distributed_tpu.infer as jax_infer
from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu.infer.cli import run_ask_cli as jax_run_ask_cli
from llm_fine_tune_distributed_tpu.models import configs as jax_configs
from llm_fine_tune_distributed_tpu.models import hf_io as jax_hf_io
from llm_fine_tune_distributed_tpu.models.transformer import init_params
import llm_fine_tune_distributed_tpu_torch.infer as port_infer
from llm_fine_tune_distributed_tpu_torch import cli
from llm_fine_tune_distributed_tpu_torch.infer import server
from llm_fine_tune_distributed_tpu_torch.infer.cli import run_ask_cli

ROOT = Path(__file__).resolve().parent.parent
QUESTION = "How many cups in a gallon?"
ASK = ["--device", "cpu", "--greedy", "--max-new-tokens", "16", QUESTION]
CLI_KW = dict(description="ask", default_model_dir="outputs/best_model", model_dir_env="MODEL_DIR",
              missing_dir_help="pass --model-dir")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny ``best_model/`` written by the JAX package, kernels x10 (at
    the 0.02 init the tied tiny model answers with an empty string)."""
    path = tmp_path_factory.mktemp("best_model")
    mc = jax_configs.get_preset("tiny")
    params = init_params(jax.random.PRNGKey(0), mc, dtype=jnp.float32)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x * 10.0 if p[-1].key == "kernel" else x, params
    )
    jax_hf_io.save_hf_checkpoint(jax.device_get(params), str(path))
    with open(path / "config.json", "w") as f:
        json.dump(jax_configs.to_hf_dict(mc), f)
    ByteChatMLTokenizer().save_pretrained(str(path))
    return path


def _answer_line(out: str) -> str:
    lines = [line for line in out.splitlines() if line.startswith("Answer: ")]
    assert len(lines) == 1, out
    return lines[0]


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_answer_line_equals_jax_cli(model_dir, quantize, monkeypatch, capsys):
    argv = ["--model-dir", str(model_dir), "--quantize", quantize] + ASK
    assert run_ask_cli(argv, **CLI_KW) == 0
    got = capsys.readouterr().out
    assert "Question: " + QUESTION in got
    assert f"quantize {quantize}" in got and "[ask] 16 tokens in" in got
    monkeypatch.setattr(jax_infer, "Generator",
                        functools.partial(jax_infer.Generator, compute_dtype=jnp.float32))
    jax_argv = [a for a in argv if a not in ("--device", "cpu")]
    assert jax_run_ask_cli(jax_argv, **CLI_KW) == 0
    want = capsys.readouterr().out
    assert _answer_line(got) == _answer_line(want) != "Answer: "


def test_answer_line_with_nf4_equals_the_jax_nf4_generator(model_dir, capsys):
    """``--quantize nf4`` (which the JAX ask CLI does not offer): the answer
    is the JAX Generator's over the JAX ``quantize_params_nf4`` of the same
    weights, asked the CLI's messages."""
    from llm_fine_tune_distributed_tpu.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT
    from llm_fine_tune_distributed_tpu.ops.nf4 import quantize_params_nf4

    argv = ["--model-dir", str(model_dir), "--quantize", "nf4"] + ASK
    assert run_ask_cli(argv, **CLI_KW) == 0
    got = capsys.readouterr().out
    assert "Quantizing block linears to NF4" in got and "quantize nf4" in got
    jparams, jmc = jax_infer.load_model_dir(str(model_dir))
    jgen = jax_infer.Generator(quantize_params_nf4(jparams), jmc, ByteChatMLTokenizer(),
                               compute_dtype=jnp.float32)
    messages = [{"role": "system", "content": WILDERNESS_EXPERT_SYSTEM_PROMPT},
                {"role": "user", "content": QUESTION}]
    ids = jgen.generate_ids(jgen.encode_chat(messages),
                            jax_infer.GenerationConfig(max_new_tokens=16, do_sample=False))
    assert _answer_line(got) == "Answer: " + jgen.decode_reply(ids) != "Answer: "


@pytest.mark.parametrize("draft", [False, True], ids=["lookup", "draft_dir"])
def test_speculative_answer_equals_the_plain_one_and_jax(model_dir, draft, monkeypatch, capsys):
    """``--speculative 4``, drafting by prompt lookup or with the model
    directory itself as ``--draft-dir``: the greedy answer is the plain one,
    and the ``Answer:`` and ``[speculative]`` lines equal the JAX CLI's."""
    base = ["--model-dir", str(model_dir)]
    assert run_ask_cli(base + ASK, **CLI_KW) == 0
    plain = _answer_line(capsys.readouterr().out)
    spec = ["--speculative", "4"] + (["--draft-dir", str(model_dir)] if draft else [])
    assert run_ask_cli(base + spec + ASK, **CLI_KW) == 0
    got = capsys.readouterr().out
    assert _answer_line(got) == plain != "Answer: "
    assert ("Draft model for speculation: " + str(model_dir) in got) == draft
    monkeypatch.setattr(jax_infer, "Generator",
                        functools.partial(jax_infer.Generator, compute_dtype=jnp.float32))
    jax_argv = [a for a in base + spec + ASK if a not in ("--device", "cpu")]
    assert jax_run_ask_cli(jax_argv, **CLI_KW) == 0
    want = capsys.readouterr().out

    def spec_line(out):
        (line,) = [x for x in out.splitlines() if x.startswith("[speculative] ")]
        return line

    assert _answer_line(got) == _answer_line(want)
    assert spec_line(got) == spec_line(want)
    if draft:
        assert spec_line(got).endswith("draft acceptance 100%")


def test_serve_flag_hands_speculation_to_the_server(model_dir, monkeypatch):
    calls = []
    monkeypatch.setattr(server, "serve", lambda *a, **kw: calls.append(kw))
    argv = ["--model-dir", str(model_dir), "--device", "cpu", "--serve", "--speculative", "3",
            "--draft-dir", str(model_dir), "--engine", "paged"]
    assert run_ask_cli(argv, **CLI_KW) == 0
    (kw,) = calls
    assert kw["speculative_k"] == 3 and kw["draft_dir"] == str(model_dir)
    assert kw["engine"] == "paged"


@pytest.fixture
def no_load(monkeypatch):
    """Loading weights fails the test: every refusal must come first."""
    def load(*a, **kw):
        raise AssertionError("weights were loaded")

    monkeypatch.setattr(port_infer, "load_model_dir", load)
    monkeypatch.setattr(server, "load_model_dir", load)


@pytest.mark.parametrize("args,message", [
    (["--draft-dir", "d", QUESTION], "--draft-dir requires --speculative"),
    (["--serve", "--speculative", "2", "--engine", "window"],
     "--speculative K applies to the continuous/paged engines"),
    (["--serve", "--speculative", "2", "--draft-dir", "d", "--engine", "window"],
     "--speculative K applies to the continuous/paged engines"),
    (["--tp", "2", QUESTION], "make_tp_mesh"),
    (["--serve", QUESTION], "--serve takes no question"),
    (["--serve", "--greedy", "--top-k", "5"], "--top-k --greedy have no effect with --serve"),
    ([], "a question is required"),
    (["--engine", "window", QUESTION], "--engine picks the --serve engine"),
], ids=["draft_without_speculative", "speculative", "draft_dir", "tp", "serve_question",
        "serve_sampling", "no_question", "engine_without_serve"])
def test_refusals_come_before_loading(model_dir, no_load, capsys, args, message):
    with pytest.raises(SystemExit) as exc:
        run_ask_cli(["--model-dir", str(model_dir), "--device", "cpu"] + args, **CLI_KW)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_missing_model_dir_returns_1_with_help(tmp_path, no_load, capsys):
    assert run_ask_cli(["--model-dir", str(tmp_path / "nope"), QUESTION], **CLI_KW) == 1
    out = capsys.readouterr().out
    assert "model directory not found" in out and "pass --model-dir" in out


def test_serve_flag_hands_quantize_and_template_to_the_server(model_dir, monkeypatch):
    calls = []
    monkeypatch.setattr(server, "serve", lambda *a, **kw: calls.append((a, kw)))
    argv = ["--model-dir", str(model_dir), "--device", "cpu", "--serve", "--quantize", "int8",
            "--port", "0"]
    assert run_ask_cli(argv, template_kwargs={"enable_thinking": False}, **CLI_KW) == 0
    (args, kw), = calls
    assert args == (str(model_dir),) and kw["quantize"] == "int8" and kw["port"] == 0
    assert kw["template_kwargs"] == {"enable_thinking": False}
    assert kw["device"] == torch.device("cpu")
    assert kw["engine"] == "continuous"  # the JAX server's default engine


@pytest.mark.parametrize("engine", ["window", "paged"])
def test_serve_flag_hands_the_engine_to_the_server(model_dir, monkeypatch, engine):
    """``--serve --engine E`` reaches ``server.serve``, which builds that
    engine (its ``build_server`` is replaced here, after the weights load)."""
    built = []

    def build(generator, **kw):
        built.append(kw)
        raise KeyboardInterrupt  # stop before binding a port

    monkeypatch.setattr(server, "build_server", build)
    argv = ["--model-dir", str(model_dir), "--device", "cpu", "--serve", "--engine", engine]
    with pytest.raises(KeyboardInterrupt):
        run_ask_cli(argv, **CLI_KW)
    (kw,) = built
    assert kw["engine"] == engine and kw["quantize_kv"] == "none"


def test_default_device_without_a_gpu_exits_nonzero(model_dir, no_load, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    with pytest.raises(SystemExit) as exc:
        cli.ask_main(["--model-dir", str(model_dir), QUESTION])
    assert exc.value.code not in (0, None)
    assert "no CUDA device" in capsys.readouterr().err


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return env


@pytest.mark.parametrize("module,via_env", [("ask_tuned_model", False),
                                             ("ask_original_model", True)])
def test_python_m_ask_modules_answer_on_the_cpu(model_dir, module, via_env):
    """Both modules run with ``python -m`` and answer (the original model's
    directory comes from BASE_MODEL_DIR)."""
    env = _env()
    cmd = [sys.executable, "-m", f"llm_fine_tune_distributed_tpu_torch.{module}"]
    if via_env:
        env["BASE_MODEL_DIR"] = str(model_dir)
    else:
        cmd += ["--model-dir", str(model_dir)]
    out = subprocess.run(cmd + ASK, capture_output=True, text=True, cwd=str(ROOT), env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert _answer_line(out.stdout) != "Answer: "


def _server_answer(model_dir, quantize):
    """Start the server with ``--quantize QUANTIZE`` on the CPU, check that
    the weights load quantized, and return one ``/v1/generate`` answer and
    the in-process Generator's reply over the same quantized weights."""
    cmd = [sys.executable, "-m", "llm_fine_tune_distributed_tpu_torch.infer.server",
           "--model-dir", str(model_dir), "--quantize", quantize, "--device", "cpu",
           "--host", "127.0.0.1", "--port", "0", "--slots", "2", "--kv-buf-len", "128",
           "--kv-block-len", "16", "--prefill-chunk", "32"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=str(ROOT), env=_env())
    try:
        lines = [proc.stdout.readline() for _ in range(2)]
        assert f"quantizing block linears to {quantize}" in lines[0].lower(), lines
        assert "listening on http://" in lines[1] and f"weights {quantize}" in lines[1], lines
        base = lines[1].split("listening on ")[1].split()[0]
        deadline = time.monotonic() + 60
        while True:
            try:
                urllib.request.urlopen(base + "/healthz", timeout=10).close()
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.1)
        body = json.dumps({"question": QUESTION, "system_prompt": "Be brief.", "greedy": True,
                           "max_new_tokens": 8}).encode()
        req = urllib.request.Request(base + "/v1/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            answer = json.loads(r.read())["answer"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    from llm_fine_tune_distributed_tpu_torch.ops.int8 import maybe_quantize

    params, mc = port_infer.load_model_dir(str(model_dir), device="cpu", dtype=torch.float32)
    gen = port_infer.Generator(maybe_quantize(params, quantize), mc,
                               port_infer.load_tokenizer_dir(str(model_dir)),
                               compute_dtype=torch.float32, device="cpu")
    want = gen.chat([{"role": "system", "content": "Be brief."},
                     {"role": "user", "content": QUESTION}],
                    port_infer.GenerationConfig(max_new_tokens=8, do_sample=False))
    return answer, want


def test_server_with_int8_weights_answers_on_the_cpu(model_dir):
    """``--quantize int8`` parses, the weights load as int8 codes and one
    ``/v1/generate`` answers with the in-process int8 Generator's reply."""
    answer, want = _server_answer(model_dir, "int8")
    assert answer == want and want


def test_server_with_nf4_weights_answers_on_the_cpu(model_dir):
    """``--quantize-weights nf4``: the weights load as NF4 codes and one
    ``/v1/generate`` answers with the in-process NF4 Generator's reply."""
    answer, want = _server_answer(model_dir, "nf4")
    assert answer == want and want
