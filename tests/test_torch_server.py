"""The port's HTTP server on the CPU against the JAX paged int8 engine, and
its refusal to start without a GPU unless the CPU is asked for."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu.infer import GenerationConfig, Generator
from llm_fine_tune_distributed_tpu.infer.engine import PagedContinuousBatchingEngine
from llm_fine_tune_distributed_tpu.models import configs as jax_configs
from llm_fine_tune_distributed_tpu.models import hf_io as jax_hf_io
from llm_fine_tune_distributed_tpu.models.transformer import init_params
from llm_fine_tune_distributed_tpu_torch.infer import server
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator as TorchGenerator
from llm_fine_tune_distributed_tpu_torch.infer.generate import load_model_dir, load_tokenizer_dir

ROOT = Path(__file__).resolve().parent.parent
ENGINE = dict(slots=4, buf_len=256, block_len=16, prefill_chunk=32)
QUESTION = {"question": "How many cups in a gallon?", "system_prompt": "Be brief.",
            "greedy": True, "max_new_tokens": 8}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny ``best_model/`` written by the JAX package."""
    path = tmp_path_factory.mktemp("best_model")
    mc = jax_configs.get_preset("tiny")
    params = init_params(jax.random.PRNGKey(0), mc, dtype=jnp.float32)
    # kernels x10: at the 0.02 init the tied tiny model echoes its last
    # input token (the assistant role id), which decodes to an empty answer
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 10.0 if path[-1].key == "kernel" else x, params
    )
    jax_hf_io.save_hf_checkpoint(jax.device_get(params), str(path))
    with open(path / "config.json", "w") as f:
        json.dump(jax_configs.to_hf_dict(mc), f)
    ByteChatMLTokenizer().save_pretrained(str(path))
    return path, params, mc


def _jax_answer(params, mc):
    tok = ByteChatMLTokenizer()
    gen = Generator(params, mc, tok, compute_dtype=jnp.float32)
    eng = PagedContinuousBatchingEngine(gen, prompt_bucket=64, kv_quant="int8", **ENGINE)
    ids = gen.encode_chat([{"role": "system", "content": QUESTION["system_prompt"]},
                           {"role": "user", "content": QUESTION["question"]}])
    out = eng.submit(ids, GenerationConfig(max_new_tokens=8, do_sample=False), timeout=240)
    return gen.decode_reply(out)


def _get(url, data=None):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read().decode()


def test_cpu_server_answers_with_the_jax_engines_greedy_text(model_dir):
    path, params, mc = model_dir
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    cmd = [sys.executable, "-m", "llm_fine_tune_distributed_tpu_torch.infer.server",
           "--model-dir", str(path), "--engine", "paged", "--quantize-kv", "int8",
           "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
           "--slots", str(ENGINE["slots"]), "--kv-buf-len", str(ENGINE["buf_len"]),
           "--kv-block-len", str(ENGINE["block_len"]),
           "--prefill-chunk", str(ENGINE["prefill_chunk"])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=str(ROOT), env=env)
    try:
        line = proc.stdout.readline()
        assert "listening on http://" in line, (line, proc.stderr.read() if proc.poll() else "")
        base = line.split("listening on ")[1].split()[0]
        deadline = time.monotonic() + 60
        while True:
            try:
                status, body = _get(base + "/healthz")
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.1)
        assert (status, body) == (200, "ok")
        status, body = _get(base + "/v1/generate", json.dumps(QUESTION).encode())
        assert status == 200
        want = _jax_answer(params, mc)
        assert want and json.loads(body) == {"answer": want}
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


def test_main_without_a_gpu_exits_naming_the_missing_card(model_dir):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    path, _, _ = model_dir
    with pytest.raises(SystemExit) as exc:
        server.main(["--model-dir", str(path), "--engine", "paged", "--quantize-kv", "int8"])
    assert exc.value.code not in (0, None)
    assert "no CUDA device" in str(exc.value.code) and "--device cpu" in str(exc.value.code)


def test_bad_requests_are_400(model_dir):
    path, _, _ = model_dir
    params, mc = load_model_dir(str(path), device="cpu", dtype=torch.float32)
    gen = TorchGenerator(params, mc, load_tokenizer_dir(str(path)),
                         compute_dtype=torch.float32, device="cpu")
    httpd, engine = server.build_server(gen, host="127.0.0.1", port=0, quantize_kv="int8",
                                        slots=2, kv_buf_len=128, kv_block_len=16,
                                        prefill_chunk=32)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        for body in (b"[1, 2]", b'{"no_question": 1}', b'{"question": "q", "speculative": 2}'):
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(base + "/v1/generate", body)
            assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(base + "/nope")
        assert err.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close()
        t.join(10)
    assert not t.is_alive()
