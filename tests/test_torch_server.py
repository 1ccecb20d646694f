"""The port's HTTP server on the CPU, engine by engine (``continuous``, the
default; ``window``; ``paged`` with an int8 KV pool), against the JAX
server's engines on the same tiny model directory: the same greedy answer
on ``/v1/generate``, ``/v1/stream`` deltas that add up to it, and
``/v1/stats`` and ``/metrics`` that count what was served; the refusals that
come before any weight loads; and the refusal to start without a GPU unless
the CPU is asked for. Multi-tenant LoRA (``tests/test_server.py``'s adapter
cases): ``--adapter-dir``'s startup refusals with the JAX messages, the
``"adapter"`` field's merged-solo answer on ``/v1/generate`` and
``/v1/stream``, its 404s and 429s, and the tenant series."""

import http.client
import json
import os
import socket
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
from llm_fine_tune_distributed_tpu.infer.batching import BatchingEngine
from llm_fine_tune_distributed_tpu.infer.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from llm_fine_tune_distributed_tpu.models import configs as jax_configs
from llm_fine_tune_distributed_tpu.models import hf_io as jax_hf_io
from llm_fine_tune_distributed_tpu.models.transformer import init_params
import llm_fine_tune_distributed_tpu_torch.infer as port_infer
from llm_fine_tune_distributed_tpu_torch.infer import engine as port_engine
from llm_fine_tune_distributed_tpu_torch.infer import server
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator as TorchGenerator
from llm_fine_tune_distributed_tpu_torch.infer.generate import load_model_dir, load_tokenizer_dir
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig as GenerationConfig_port

ROOT = Path(__file__).resolve().parent.parent
ENGINES = ("continuous", "window", "paged")
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


def _jax_answer(params, mc, engine):
    """The JAX server's engine of the same kind, at the same geometry."""
    gen = Generator(params, mc, ByteChatMLTokenizer(), compute_dtype=jnp.float32)
    if engine == "window":
        eng = BatchingEngine(gen, max_batch=4, window_ms=10.0)
    elif engine == "continuous":
        eng = ContinuousBatchingEngine(gen, slots=ENGINE["slots"], buf_len=ENGINE["buf_len"],
                                       prompt_bucket=64)
    else:
        eng = PagedContinuousBatchingEngine(gen, prompt_bucket=64, kv_quant="int8", **ENGINE)
    ids = gen.encode_chat([{"role": "system", "content": QUESTION["system_prompt"]},
                           {"role": "user", "content": QUESTION["question"]}])
    out = eng.submit(ids, GenerationConfig(max_new_tokens=8, do_sample=False), timeout=240)
    return gen.decode_reply(out)


def _get(url, data=None):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read().decode()


def _stream(base, body):
    """POST /v1/stream -> (status, [(event, payload)]); the chunked body is
    decoded by http.client."""
    host, port = base.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    try:
        conn.request("POST", "/v1/stream", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.getheader("Content-Type") == "text/event-stream"
        text = resp.read().decode()
    finally:
        conn.close()
    events = []
    for block in text.split("\n\n"):
        if not block:
            continue
        lines = block.split("\n")
        name = lines[0][len("event: "):] if lines[0].startswith("event: ") else "message"
        assert lines[-1].startswith("data: "), block
        events.append((name, json.loads(lines[-1][len("data: "):])))
    return resp.status, events


def _prometheus(text):
    """Every line of a Prometheus exposition parsed: TYPE lines and samples."""
    samples, types = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            assert kind in ("counter", "gauge", "histogram"), line
            types[name] = kind
        else:
            name, value = line.rsplit(" ", 1)
            samples[name] = float(value)
    return types, samples


@pytest.fixture(scope="module", params=ENGINES)
def served(request, model_dir):
    """``python -m ...infer.server --device cpu --engine E`` on the tiny
    model; yields (engine, base URL, the JAX engine's answer)."""
    engine = request.param
    path, params, mc = model_dir
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    cmd = [sys.executable, "-m", "llm_fine_tune_distributed_tpu_torch.infer.server",
           "--model-dir", str(path), "--engine", engine, "--device", "cpu",
           "--host", "127.0.0.1", "--port", "0",
           "--slots", str(ENGINE["slots"]), "--kv-buf-len", str(ENGINE["buf_len"]),
           "--kv-block-len", str(ENGINE["block_len"]),
           "--prefill-chunk", str(ENGINE["prefill_chunk"]), "--max-batch", "4"]
    if engine == "paged":
        cmd += ["--quantize-kv", "int8"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=str(ROOT), env=env)
    try:
        line = proc.stdout.readline()
        assert "listening on http://" in line and f"engine {engine}" in line, (
            line, proc.stderr.read() if proc.poll() is not None else "")
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
        yield engine, base, _jax_answer(params, mc, engine)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


def test_cpu_server_answers_with_the_jax_engines_greedy_text(served):
    _, base, want = served
    status, body = _get(base + "/v1/generate", json.dumps(QUESTION).encode())
    assert status == 200
    assert want and json.loads(body) == {"answer": want}


@pytest.fixture(scope="module")
def port_generator(model_dir):
    path, _, _ = model_dir
    params, mc = load_model_dir(str(path), device="cpu", dtype=torch.float32)
    return TorchGenerator(params, mc, load_tokenizer_dir(str(path)),
                          compute_dtype=torch.float32, device="cpu")


class _Server:
    """``build_server`` on a thread, for one test."""

    def __init__(self, gen, **kw):
        self.httpd, self.engine = server.build_server(gen, host="127.0.0.1", port=0, **kw)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.engine.close()
        self.thread.join(10)
        assert not self.thread.is_alive()


def _engine_kw(engine):
    kw = dict(engine=engine, slots=ENGINE["slots"], kv_buf_len=ENGINE["buf_len"],
              kv_block_len=ENGINE["block_len"], prefill_chunk=ENGINE["prefill_chunk"], max_batch=4)
    if engine == "paged":
        kw["quantize_kv"] = "int8"
    return kw


@pytest.mark.parametrize("engine", ENGINES)
def test_stream_deltas_concatenate_to_the_generate_answer(port_generator, engine):
    """The same request on two fresh servers of one engine, one through
    ``/v1/generate`` and one through ``/v1/stream`` (fresh, because a freed
    int8 block keeps its scale: the paged engine's tokens depend on its
    pool's history, in the JAX package too)."""
    with _Server(port_generator, **_engine_kw(engine)) as srv:
        _, body = _get(srv.base + "/v1/generate", json.dumps(QUESTION).encode())
    with _Server(port_generator, **_engine_kw(engine)) as srv:
        status, events = _stream(srv.base, QUESTION)
    assert status == 200
    assert [name for name, _ in events] == ["message"] * len(events)
    *deltas, done = [payload for _, payload in events]
    assert done == {"done": True, "n_tokens": QUESTION["max_new_tokens"]}
    assert deltas and all(set(d) == {"delta"} for d in deltas)
    answer = json.loads(body)["answer"]
    assert answer and "".join(d["delta"] for d in deltas).strip() == answer


def test_stats_and_metrics_count_the_requests_served(served):
    engine, base, _ = served
    _, before = _get(base + "/v1/stats")
    _, events = _stream(base, QUESTION)
    n_tokens = events[-1][1]["n_tokens"]
    _get(base + "/v1/generate", json.dumps(QUESTION).encode())
    _, after = _get(base + "/v1/stats")
    with urllib.request.urlopen(base + "/metrics", timeout=120) as r:
        assert r.status == 200
        assert r.headers["Content-Type"] == server.PROMETHEUS_CONTENT_TYPE
        types, samples = _prometheus(r.read().decode())
    before, after = json.loads(before), json.loads(after)
    assert after["engine"] == engine
    if engine == "window":
        assert samples[f'serving_info{{engine="{engine}"}}'] == 1
        # the JAX server's window stats: the queue, and the cards' memory
        # (none on the CPU)
        assert after == {"engine": "window", "queue_depth": 0, "max_batch": 4,
                         "device_memory": {}}
        assert samples["serving_queue_depth"] == 0 and types["serving_max_batch"] == "gauge"
        return
    # a slot engine's snapshot also carries its supervision state and its
    # role, as the JAX engine's does: the circuit and the role as labels,
    # the drain as a 0/1 gauge
    assert after["circuit_state"] == "closed" and after["draining"] is False
    assert samples[f'serving_info{{circuit_state="closed",engine="{engine}",role="mixed"}}'] == 1
    assert types["serving_draining"] == "gauge" and samples["serving_draining"] == 0
    assert samples["serving_engine_restarts_total"] == 0 == samples["serving_engine_generation"]
    assert after["tokens_served"] - before["tokens_served"] == n_tokens + 8
    assert after["requests_completed"] - before["requests_completed"] == 2
    assert after["live_slots"] == 0 and after["queue_depth"] == 0
    assert types["serving_tokens_served_total"] == "counter"
    assert samples["serving_tokens_served_total"] == after["tokens_served"]
    assert samples["serving_requests_completed_total"] == after["requests_completed"]
    assert samples['serving_ttft_seconds_bucket{le="+Inf"}'] == after["requests_completed"]
    if engine == "paged":
        assert after["total_blocks"] > 0 and after["prefix_tokens_reused"] > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_bad_requests_are_400(port_generator, engine):
    """Malformed bodies are 400. An ``"adapter"`` is 400 on the window
    engine and, on a slot engine started without ``--adapter-dir``, the
    JAX server's 404 naming the flag."""
    with _Server(port_generator, **_engine_kw(engine)) as srv:
        for route in ("/v1/generate", "/v1/stream"):
            for body in (b"[1, 2]", b'{"no_question": 1}', b'{"question": "q", "adapter": 7}',
                         b'{"question": "q", "stream_chunk": 0}'):
                with pytest.raises(urllib.error.HTTPError) as err:
                    _get(srv.base + route, body)
                assert err.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(srv.base + route, b'{"question": "q", "adapter": "a"}')
            if engine == "window":
                assert err.value.code == 400
            else:
                assert err.value.code == 404
                error = json.loads(err.value.read())["error"]
                assert error["kind"] == "unknown_adapter" and "--adapter-dir" in error["message"]
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(srv.base + "/nope")
        assert err.value.code == 404


def _jax_spec_counts(params, mc, engine, k):
    """The JAX engine's record of QUESTION with ``speculative_lookup`` k:
    (answer, acceptance, proposed, accepted); the slot engines run with
    ``speculative_k`` k."""
    gen = Generator(params, mc, ByteChatMLTokenizer(), compute_dtype=jnp.float32)
    if engine == "window":
        eng = BatchingEngine(gen, max_batch=4, window_ms=10.0)
    elif engine == "continuous":
        eng = ContinuousBatchingEngine(gen, slots=ENGINE["slots"], buf_len=ENGINE["buf_len"],
                                       prompt_bucket=64, speculative_k=k)
    else:
        eng = PagedContinuousBatchingEngine(gen, prompt_bucket=64, kv_quant="int8",
                                            speculative_k=k, **ENGINE)
    ids = gen.encode_chat([{"role": "system", "content": QUESTION["system_prompt"]},
                           {"role": "user", "content": QUESTION["question"]}])
    req = eng.submit_full(ids, GenerationConfig(max_new_tokens=8, do_sample=False,
                                                speculative_lookup=k), timeout=240)
    return (gen.decode_reply(req.result), round(req.spec_acceptance, 3),
            req.draft_tokens_proposed, req.draft_tokens_accepted)


@pytest.mark.parametrize("engine", ENGINES)
def test_speculative_generate_returns_the_jax_block(model_dir, port_generator, engine):
    """``"speculative": 4`` on ``/v1/generate``: the slot engines started
    with ``speculative_k=4``, the window engine through ``generate_batch``.
    The answer is the plain greedy one, and the ``"speculative"`` block
    holds the request's own counts, equal to the JAX engine's (the window
    engine's also its batch's sequential forwards)."""
    _, params, mc = model_dir
    k = 4
    kw = _engine_kw(engine)
    if engine != "window":
        kw["speculative_k"] = k
    with _Server(port_generator, **kw) as srv:
        _, plain = _get(srv.base + "/v1/generate", json.dumps(QUESTION).encode())
        status, body = _get(srv.base + "/v1/generate",
                            json.dumps({**QUESTION, "speculative": k}).encode())
    assert status == 200
    body, plain = json.loads(body), json.loads(plain)
    answer, rate, proposed, accepted = _jax_spec_counts(params, mc, engine, k)
    assert body["answer"] == plain["answer"] == answer and "speculative" not in plain
    block = {"acceptance_rate": rate, "draft_tokens_proposed": proposed,
             "draft_tokens_accepted": accepted}
    if engine == "window":
        assert body["speculative"].pop("sequential_forwards") >= 2
        assert proposed > 0
    assert body["speculative"] == block


def test_slot_engine_without_speculation_hands_speculative_requests_to_the_window(
        port_generator):
    """A continuous engine started without ``speculative_k``: a
    ``"speculative"`` request runs ``generate_batch``'s speculative path on
    the window engine the server keeps beside it (its block has the
    sequential forwards); the slot engine never sees it."""
    with _Server(port_generator, **_engine_kw("continuous")) as srv:
        status, body = _get(srv.base + "/v1/generate",
                            json.dumps({**QUESTION, "speculative": 3}).encode())
        served = srv.engine.stats_snapshot()["requests_completed"]
        window = srv.httpd.window_engine
    assert status == 200 and served == 0
    block = json.loads(body)["speculative"]
    assert block["draft_tokens_proposed"] > 0 and block["sequential_forwards"] >= 2
    assert not window._worker.is_alive()  # server_close stopped it


@pytest.mark.parametrize("engine", ["continuous", "paged"])
def test_speculative_stream_rides_the_spec_tick(port_generator, engine):
    """``/v1/stream`` with ``"speculative"`` on a slot engine started with
    ``speculative_k``: the deltas add up to the ``/v1/generate`` answer of
    a fresh server, and the engine counts the drafts."""
    kw = {**_engine_kw(engine), "speculative_k": 4}
    body = {**QUESTION, "speculative": 4}
    with _Server(port_generator, **kw) as srv:
        _, answer = _get(srv.base + "/v1/generate", json.dumps(body).encode())
    with _Server(port_generator, **kw) as srv:
        status, events = _stream(srv.base, body)
        snap = srv.engine.stats_snapshot()
    assert status == 200
    *deltas, done = [payload for _, payload in events]
    assert done == {"done": True, "n_tokens": QUESTION["max_new_tokens"]}
    assert "".join(d["delta"] for d in deltas).strip() == json.loads(answer)["answer"]
    assert snap["decode_steps"] >= 1 and snap["requests_completed"] == 1


@pytest.mark.parametrize("engine,message", [
    ("window", "needs a continuous/paged engine started with --speculative K"),
    ("continuous", "needs the server started with --speculative K"),
    ("paged", "needs the server started with --speculative K"),
])
def test_speculative_stream_without_a_spec_engine_is_400(port_generator, engine, message):
    with _Server(port_generator, **_engine_kw(engine)) as srv:
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(srv.base + "/v1/stream", json.dumps({**QUESTION, "speculative": 2}).encode())
        assert err.value.code == 400
        assert message in json.loads(err.value.read())["error"]
        # "speculative": 0 is the documented off value and streams plainly
        status, _ = _stream(srv.base, {**QUESTION, "speculative": 0})
        assert status == 200


@pytest.mark.parametrize("args,message", [
    (["--draft-dir", "d"], "--draft-dir requires --speculative K"),
    (["--speculative", "2", "--engine", "window"],
     "--speculative K applies to the continuous/paged engines"),
], ids=["draft_without_speculative", "speculative_on_window"])
def test_speculation_refusals_come_before_loading(model_dir, no_load, capsys, args, message):
    path, _, _ = model_dir
    with pytest.raises(SystemExit) as exc:
        server.main(["--model-dir", str(path), "--device", "cpu"] + args)
    assert exc.value.code == 2 and message in capsys.readouterr().err
    kw = dict(speculative_k=2 if "--speculative" in args else 0,
              draft_dir="d" if "--draft-dir" in args else None,
              engine="window" if "window" in args else "continuous")
    with pytest.raises(ValueError, match=message.split(" (")[0].replace("|", r"\|")):
        server.serve(str(path), device="cpu", **kw)


def test_speculative_flags_reach_serve(model_dir, monkeypatch):
    path, _, _ = model_dir
    calls = []
    monkeypatch.setattr(server, "serve", lambda *a, **kw: calls.append(kw))
    assert server.main(["--model-dir", str(path), "--device", "cpu", "--speculative", "4",
                        "--draft-dir", str(path)]) == 0
    (kw,) = calls
    assert kw["speculative_k"] == 4 and kw["draft_dir"] == str(path)


def test_client_that_disconnects_mid_stream_abandons_its_request(port_generator):
    """The client reads the headers and hangs up: the slot stops decoding
    for nobody, and the request counts as abandoned."""
    with _Server(port_generator, slots=2, kv_buf_len=1024) as srv:
        eng = srv.engine
        assert isinstance(eng, port_engine.ContinuousBatchingEngine)  # the default engine
        body = json.dumps({**QUESTION, "max_new_tokens": 900}).encode()
        with socket.create_connection(("127.0.0.1", srv.httpd.server_address[1]), timeout=60) as s:
            s.sendall(b"POST /v1/stream HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                      + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
            assert s.recv(4096).startswith(b"HTTP/1.1 200")
        deadline = time.monotonic() + 60
        while eng.stats_snapshot()["requests_abandoned"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        snap = eng.stats_snapshot()
    assert snap["requests_completed"] == 0 and snap["live_slots"] == 0
    assert snap["tokens_served"] < 900


@pytest.fixture
def no_load(monkeypatch):
    """Loading weights fails the test: every refusal must come first."""
    def load(*a, **kw):
        raise AssertionError("weights were loaded")

    monkeypatch.setattr(port_infer, "load_model_dir", load)
    monkeypatch.setattr(server, "load_model_dir", load)


@pytest.mark.parametrize("engine", ["continuous", "window"])
def test_quantize_kv_is_refused_before_loading(model_dir, no_load, capsys, engine):
    path, _, _ = model_dir
    with pytest.raises(SystemExit) as exc:
        server.main(["--model-dir", str(path), "--engine", engine, "--quantize-kv", "int8",
                     "--device", "cpu"])
    assert exc.value.code == 2 and "pick --engine paged" in capsys.readouterr().err
    with pytest.raises(ValueError, match="pick --engine paged"):
        server.serve(str(path), device="cpu", engine=engine, quantize_kv="int8")


def test_default_engine_is_continuous(model_dir, monkeypatch):
    path, _, _ = model_dir
    calls = []
    monkeypatch.setattr(server, "serve", lambda *a, **kw: calls.append(kw))
    assert server.main(["--model-dir", str(path), "--device", "cpu"]) == 0
    (kw,) = calls
    assert kw["engine"] == "continuous" and kw["quantize_kv"] == "none"
    assert kw["max_batch"] == 8 and kw["batch_window_ms"] == 10.0


def test_main_without_a_gpu_exits_naming_the_missing_card(model_dir):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    path, _, _ = model_dir
    with pytest.raises(SystemExit) as exc:
        server.main(["--model-dir", str(path), "--engine", "paged", "--quantize-kv", "int8"])
    assert exc.value.code not in (0, None)
    assert "no CUDA device" in str(exc.value.code) and "--device cpu" in str(exc.value.code)


# ------------------------------------------------- multi-tenant LoRA serving


@pytest.mark.parametrize("kw,message", [
    (dict(adapter_dir="/whatever", engine="window"),
     "--adapter-dir (multi-tenant LoRA serving) needs a continuous/paged engine"),
    (dict(adapter_dir="/no/such/dir"), "--adapter-dir not found: '/no/such/dir'"),
], ids=["window", "missing_dir"])
def test_adapter_flag_validation_at_startup(model_dir, no_load, capsys, kw, message):
    """Bad adapter settings fail at startup, before the model loads, with
    the JAX server's messages (``serve`` and the CLI)."""
    from llm_fine_tune_distributed_tpu.infer.server import serve as jax_serve

    with pytest.raises(ValueError) as want:
        jax_serve("/nonexistent", adapter_dir=kw["adapter_dir"],
                  engine_kind=kw.get("engine", "continuous"))
    with pytest.raises(ValueError) as got:
        server.serve("/nonexistent", device="cpu", **kw)
    assert str(got.value) == str(want.value) and message in str(got.value)
    path, _, _ = model_dir
    with pytest.raises(SystemExit) as exc:
        server.main(["--model-dir", str(path), "--device", "cpu", "--adapter-dir",
                     kw["adapter_dir"], "--engine", kw.get("engine", "continuous")])
    assert exc.value.code == 2 and message in capsys.readouterr().err


@pytest.fixture(scope="module")
def adapter_root(model_dir, tmp_path_factory):
    """Two PEFT adapters (JAX ``save_lora_adapter``) for the served model,
    with large B so that the adapted greedy answer visibly moves."""
    from llm_fine_tune_distributed_tpu.config import TrainConfig
    from llm_fine_tune_distributed_tpu.parallel.lora import add_lora_params, save_lora_adapter

    _, params, _ = model_dir
    root = tmp_path_factory.mktemp("srv_adapters")
    for name, seed in (("acme", 1), ("globex", 2)):
        adapted = add_lora_params(params, jax.random.PRNGKey(seed), rank=4, alpha=8.0)

        def bump(node, scale=0.5 * seed):
            if isinstance(node, dict):
                if "lora_b" in node:
                    return {**node, "lora_b": jnp.ones_like(node["lora_b"]) * scale}
                return {k: bump(v) for k, v in node.items()}
            return node

        save_lora_adapter(bump(adapted), str(root / name),
                          TrainConfig(freeze_strategy="lora", lora_rank=4, lora_alpha=8.0))
    return str(root)


def test_quantized_weights_refuse_the_adapter_pool(model_dir, adapter_root):
    """``--quantize int8 --adapter-dir``: the JAX registry finds no plain
    kernel under int8 weights and refuses at build; so does the port."""
    path, _, _ = model_dir
    with pytest.raises(ValueError,
                       match="the model has no linear module matching the adapter pool targets"):
        server.serve(str(path), device="cpu", quantize="int8", adapter_dir=adapter_root,
                     port=0, slots=2, kv_buf_len=256)


@pytest.fixture(scope="module")
def adapter_server(port_generator, adapter_root):
    with _Server(port_generator, adapter_dir=adapter_root, slots=4, kv_buf_len=256,
                 max_adapters=4) as srv:
        yield srv


def _post_json(base, path, body):
    return json.loads(_get(base + path, json.dumps(body).encode())[1])


def test_generate_with_adapter(adapter_server, port_generator, adapter_root):
    """``"adapter"`` selects the tenant's delta: the answer is its merged
    weights' solo answer, not the base answer, and base answers are
    unchanged by adapter traffic."""
    from llm_fine_tune_distributed_tpu_torch.parallel.lora import load_lora_adapter, merge_lora

    body = {"question": "What is 2+2?", "system_prompt": "Be brief.", "max_new_tokens": 8,
            "greedy": True}
    base_answer = _post_json(adapter_server.base, "/v1/generate", body)["answer"]
    acme_answer = _post_json(adapter_server.base, "/v1/generate",
                             {**body, "adapter": "acme"})["answer"]
    assert acme_answer != base_answer
    merged = TorchGenerator(merge_lora(load_lora_adapter(
        port_generator.params, os.path.join(adapter_root, "acme"))), port_generator.config,
        port_generator.tokenizer, compute_dtype=torch.float32, device="cpu")
    assert acme_answer == merged.chat(
        [{"role": "system", "content": body["system_prompt"]},
         {"role": "user", "content": body["question"]}],
        GenerationConfig_port(max_new_tokens=8, do_sample=False))
    assert _post_json(adapter_server.base, "/v1/generate", body)["answer"] == base_answer


def test_generate_unknown_adapter_404_lists_known(adapter_server):
    with pytest.raises(urllib.error.HTTPError) as he:
        _get(adapter_server.base + "/v1/generate",
             json.dumps({"question": "q?", "max_new_tokens": 4, "adapter": "ghost"}).encode())
    assert he.value.code == 404
    err = json.loads(he.value.read())["error"]
    assert err["kind"] == "unknown_adapter"
    assert set(err["known_adapters"]) == {"acme", "globex"}


def test_adapter_without_registry_404(port_generator):
    """A server without --adapter-dir names the missing flag in its 404."""
    with _Server(port_generator, slots=2, kv_buf_len=256) as srv:
        with pytest.raises(urllib.error.HTTPError) as he:
            _get(srv.base + "/v1/generate",
                 json.dumps({"question": "q?", "max_new_tokens": 4, "adapter": "acme"}).encode())
    assert he.value.code == 404
    err = json.loads(he.value.read())["error"]
    assert err["kind"] == "unknown_adapter" and "--adapter-dir" in err["message"]


def test_stream_with_adapter(adapter_server):
    """A stream rides the shared batch with the tenant's delta: its deltas
    add up to the adapted /v1/generate answer."""
    body = {**QUESTION, "adapter": "acme"}
    answer = _post_json(adapter_server.base, "/v1/generate", body)["answer"]
    status, events = _stream(adapter_server.base, body)
    assert status == 200 and events[-1][1].get("done") is True
    assert "".join(p.get("delta", "") for _, p in events).strip() == answer


def test_adapter_stats_and_metrics_per_tenant(adapter_server):
    _post_json(adapter_server.base, "/v1/generate", {**QUESTION, "adapter": "acme"})
    stats = json.loads(_get(adapter_server.base + "/v1/stats")[1])
    assert stats["per_tenant"]["acme"]["requests"] >= 1
    assert stats["per_tenant"]["acme"]["tokens"] >= 1
    assert stats["adapters_resident"] >= 1 and stats["adapter_loads"] >= 1
    text = _get(adapter_server.base + "/metrics")[1]
    assert 'serving_tenant_tokens_total{tenant="acme"}' in text
    assert "serving_adapters_resident" in text
    assert 'serving_tenant_ttft_seconds_count{tenant="acme"}' in text


def test_adapter_field_window_engine_400(port_generator):
    with _Server(port_generator, engine="window", max_batch=4) as srv:
        with pytest.raises(urllib.error.HTTPError) as he:
            _get(srv.base + "/v1/generate",
                 json.dumps({"question": "q?", "max_new_tokens": 4, "adapter": "acme"}).encode())
    assert he.value.code == 400
    msg = json.loads(he.value.read())["error"]
    assert "--adapter-dir" in msg and "continuous" in msg


class _GatedGen:
    """The port's Generator with its dense decode step behind an event."""

    def __init__(self, gen):
        self._gen = gen
        self.parked = threading.Event()
        self.go = threading.Event()

    def __getattr__(self, name):
        return getattr(self._gen, name)

    def slot_step(self, *a):
        if not self.go.is_set():
            self.parked.set()
            self.go.wait(120)
        return self._gen.slot_step(*a)


def test_full_pool_and_tenant_quota_are_429(port_generator, adapter_root):
    """One adapter slot and a quota of one request per tenant: while acme
    decodes, globex (the pool is pinned) and a second acme (over quota) get
    429 with Retry-After and the JAX error kinds."""
    gated = _GatedGen(port_generator)
    with _Server(gated, adapter_dir=adapter_root, slots=4, kv_buf_len=256, max_adapters=2,
                 adapter_capacity=1) as srv:
        body = {**QUESTION, "max_new_tokens": 4}
        holder = threading.Thread(target=lambda: _get(srv.base + "/v1/generate", json.dumps(
            {**body, "adapter": "acme"}).encode()))
        holder.start()
        try:
            assert gated.parked.wait(120), "acme never reached its first decode step"
            kinds = []
            for tenant in ("globex", "acme"):
                with pytest.raises(urllib.error.HTTPError) as he:
                    _get(srv.base + "/v1/generate",
                         json.dumps({**body, "adapter": tenant}).encode())
                assert he.value.code == 429 and int(he.value.headers["Retry-After"]) >= 1
                kinds.append(json.loads(he.value.read())["error"]["kind"])
            assert kinds == ["adapter_pool_full", "tenant_quota"]
        finally:
            gated.go.set()
            holder.join(120)
        stats = json.loads(_get(srv.base + "/v1/stats")[1])
        assert stats["requests_shed_tenant_quota"] == 1 and stats["per_tenant"]["acme"][
            "requests"] == 1


def test_adapter_flags_reach_serve(model_dir, monkeypatch):
    path, _, _ = model_dir
    calls = []
    monkeypatch.setattr(server, "serve", lambda *a, **kw: calls.append(kw))
    assert server.main(["--model-dir", str(path), "--device", "cpu", "--adapter-dir",
                        str(path), "--max-adapters", "3", "--adapter-capacity", "2"]) == 0
    assert server.main(["--model-dir", str(path), "--device", "cpu"]) == 0
    assert [(kw["adapter_dir"], kw["max_adapters"], kw["adapter_capacity"]) for kw in calls] == [
        (str(path), 3, 2), (None, 8, 0)]


# ------------------------------------------------------------ live deployment


def test_publish_watch_dir_refused_on_the_window_engine_before_loading(model_dir, no_load,
                                                                       capsys, tmp_path):
    """--publish-watch-dir on the window engine fails before the model
    loads, with the JAX server's message (``serve`` and the CLI)."""
    from llm_fine_tune_distributed_tpu.infer.server import serve as jax_serve

    with pytest.raises(ValueError) as want:
        jax_serve("/nonexistent", engine_kind="window", publish_watch_dir=str(tmp_path))
    with pytest.raises(ValueError) as got:
        server.serve("/nonexistent", device="cpu", engine="window",
                     publish_watch_dir=str(tmp_path))
    assert str(got.value) == str(want.value) and "--publish-watch-dir" in str(got.value)
    path, _, _ = model_dir
    with pytest.raises(SystemExit) as exc:
        server.main(["--model-dir", str(path), "--device", "cpu", "--engine", "window",
                     "--publish-watch-dir", str(tmp_path)])
    assert exc.value.code == 2 and "checkpoint hot-swap" in capsys.readouterr().err


def test_deploy_flags_reach_serve_with_the_jax_defaults(model_dir, monkeypatch, tmp_path):
    from llm_fine_tune_distributed_tpu.infer import server as jax_server

    keys = ("publish_watch_dir", "publish_poll_s", "auto_rollback_window_s",
            "auto_rollback_error_rate", "canary_window_s", "canary_min_requests")
    path, _, _ = model_dir
    calls, jax_calls = [], []
    monkeypatch.setattr(server, "serve", lambda *a, **kw: calls.append(kw))
    monkeypatch.setattr(jax_server, "serve", lambda *a, **kw: jax_calls.append(kw))
    monkeypatch.delenv("PUBLISH_DIR", raising=False)
    assert server.main(["--model-dir", str(path), "--device", "cpu"]) == 0
    jax_server.main(["--model-dir", str(path)])
    assert {k: calls[-1][k] for k in keys} == {k: jax_calls[-1][k] for k in keys}
    args = ["--publish-watch-dir", str(tmp_path), "--publish-poll-s", "0.5",
            "--auto-rollback-window-s", "30", "--auto-rollback-error-rate", "0.2",
            "--canary-window-s", "5", "--canary-min-requests", "3"]
    assert server.main(["--model-dir", str(path), "--device", "cpu"] + args) == 0
    jax_server.main(["--model-dir", str(path)] + args)
    assert {k: calls[-1][k] for k in keys} == {k: jax_calls[-1][k] for k in keys} == {
        "publish_watch_dir": str(tmp_path), "publish_poll_s": 0.5,
        "auto_rollback_window_s": 30.0, "auto_rollback_error_rate": 0.2,
        "canary_window_s": 5.0, "canary_min_requests": 3}
    monkeypatch.setenv("PUBLISH_DIR", str(tmp_path))
    assert server.main(["--model-dir", str(path), "--device", "cpu"]) == 0
    assert calls[-1]["publish_watch_dir"] == str(tmp_path)
