"""The port's server with a fleet (``infer/server.py``'s fleet flags and
routes) against the JAX server's:

- each refusal of the ten fleet flags (``--replicas``, ``--routing``,
  ``--replica-roles``, ``--host-tier-mb``, ``--migrate-on-retire``,
  ``--autoscale``, ``--min-replicas``, ``--max-replicas``,
  ``--scale-cooldown-s``, ``--autoscale-ratio``) comes before any weight
  loads, from ``main`` (exit 2) and from ``serve`` (ValueError), with the
  JAX server's message for the same settings;
- the flags reach ``serve`` with the JAX server's defaults;
- a fleet server on port 0 answers ``/v1/stats`` with the merged view and a
  ``per_replica`` map, ``/metrics`` with one ``replica="i"`` sample per
  replica, ``/v1/flight`` and ``/v1/capacity`` with the fleet's views, and
  ``POST /v1/fleet/scale`` grows and shrinks it within its bounds (400
  outside them or on a bad body, 404 without a fleet);
- ``--replica-roles prefill,decode --host-tier-mb`` hands each request from
  the prefill replica to the decode replica, with the answer of a single
  engine.
"""

import http.client
import json
import re
import threading

import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer import server
from llm_fine_tune_distributed_tpu_torch.infer.fleet import EngineFleet
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator
from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset

TIMEOUT = 240
QUESTION = {"question": "How many cups in a gallon?", "system_prompt": "Be brief.",
            "greedy": True, "max_new_tokens": 6}
GEOMETRY = dict(engine="paged", slots=2, kv_buf_len=256, kv_block_len=16, prefill_chunk=64,
                max_batch=2, flight_dir=None)

# (main's arguments, serve's keywords, the start of the JAX server's message)
REFUSALS = [
    (["--replicas", "2", "--engine", "window"], dict(replicas=2, engine="window"),
     "--replicas N needs a continuous/paged engine"),
    (["--replicas", "2", "--max-replicas", "1"], dict(replicas=2, max_replicas=1),
     "--max-replicas must be >= --replicas"),
    (["--min-replicas", "2"], dict(min_replicas=2), "--min-replicas must be <= --replicas"),
    (["--max-replicas", "2", "--engine", "window"], dict(max_replicas=2, engine="window"),
     "--max-replicas (elastic fleet growth) needs a continuous/paged engine"),
    (["--host-tier-mb", "64"], dict(host_tier_mb=64),
     "--host-tier-mb spills paged KV BLOCKS to host RAM"),
    (["--migrate-on-retire"], dict(migrate_on_retire=True),
     "--migrate-on-retire live-migrates a retiring replica's"),
    (["--replicas", "2", "--replica-roles", "prefill,verifier"],
     dict(replicas=2, replica_roles="prefill,verifier"), "unknown role(s) ['verifier']"),
    (["--replicas", "2", "--replica-roles", "prefill"], dict(replicas=2, replica_roles="prefill"),
     "--replica-roles must name one role per starting replica"),
    (["--replica-roles", "mixed"], dict(replica_roles="mixed"),
     "--replica-roles splits a FLEET into prefill/decode pools"),
    (["--replicas", "2", "--engine", "paged", "--replica-roles", "prefill,decode"],
     dict(replicas=2, engine="paged", replica_roles="prefill,decode"),
     "prefill/decode roles hand a request over"),
    (["--replicas", "2", "--autoscale-ratio"], dict(replicas=2, autoscale_ratio=True),
     "--autoscale-ratio treats the prefill/decode pool ratio"),
]
# refused by argparse in main (a choice), and by serve with the JAX message
CHOICE_REFUSALS = [
    (["--routing", "hash-ring"], dict(routing="hash-ring"), "unknown --routing 'hash-ring'"),
    (["--autoscale", "auto"], dict(autoscale="auto"), "unknown --autoscale mode 'auto'"),
]


def _jax_message(kw):
    """The JAX server's refusal of the same settings (it refuses before it
    loads anything)."""
    from llm_fine_tune_distributed_tpu.infer import server as jax_server

    kw = dict(kw)
    kw["engine_kind"] = kw.pop("engine", "continuous")
    with pytest.raises(ValueError) as exc:
        jax_server.serve("unused-model-dir", **kw)
    return str(exc.value)


@pytest.fixture
def no_load(monkeypatch):
    """Loading weights fails the test: every refusal must come first."""
    def load(*a, **kw):
        raise AssertionError("weights were loaded")

    monkeypatch.setattr(server, "load_model_dir", load)


@pytest.mark.parametrize("args,kw,message", REFUSALS,
                         ids=[f"refusal{i}" for i in range(len(REFUSALS))])
def test_fleet_flag_refusals_come_before_loading(no_load, capsys, args, kw, message):
    jax_message = _jax_message(kw)
    assert jax_message.startswith(message)
    with pytest.raises(SystemExit) as exc:
        server.main(["--model-dir", "unused-model-dir", "--device", "cpu"] + args)
    assert exc.value.code == 2 and jax_message in capsys.readouterr().err
    with pytest.raises(ValueError) as err:
        server.serve("unused-model-dir", device="cpu", **kw)
    assert str(err.value) == jax_message


@pytest.mark.parametrize("args,kw,message", CHOICE_REFUSALS, ids=["routing", "autoscale"])
def test_fleet_flag_choices_are_refused_before_loading(no_load, capsys, args, kw, message):
    jax_message = _jax_message(kw)
    assert jax_message.startswith(message)
    with pytest.raises(SystemExit) as exc:
        server.main(["--model-dir", "unused-model-dir", "--device", "cpu"] + args)
    assert exc.value.code == 2 and "invalid choice" in capsys.readouterr().err
    with pytest.raises(ValueError) as err:
        server.serve("unused-model-dir", device="cpu", **kw)
    assert str(err.value) == jax_message


FLEET_DEFAULTS = dict(replicas=1, routing="prefix", replica_roles=None, host_tier_mb=0,
                      migrate_on_retire=False, autoscale="dry-run", min_replicas=1,
                      max_replicas=0, scale_cooldown_s=30.0, autoscale_ratio=False)


def test_fleet_flags_reach_serve_with_the_jax_defaults(monkeypatch, tmp_path):
    from llm_fine_tune_distributed_tpu.infer import server as jax_server

    d = str(tmp_path)  # the JAX main wants the directory to exist
    calls, jax_calls = [], []
    monkeypatch.setattr(server, "serve", lambda *a, **kw: calls.append(kw))
    monkeypatch.setattr(jax_server, "serve", lambda *a, **kw: jax_calls.append(kw))
    assert server.main(["--model-dir", d, "--device", "cpu"]) == 0
    jax_server.main(["--model-dir", d])
    (kw,), (jkw,) = calls, jax_calls
    assert {k: kw[k] for k in FLEET_DEFAULTS} == {k: jkw[k] for k in FLEET_DEFAULTS} == \
        FLEET_DEFAULTS
    args = ["--replicas", "3", "--routing", "least-loaded", "--replica-roles",
            "prefill,decode,mixed", "--host-tier-mb", "64", "--migrate-on-retire",
            "--autoscale", "on", "--min-replicas", "2", "--max-replicas", "4",
            "--scale-cooldown-s", "5", "--autoscale-ratio", "--engine", "paged"]
    assert server.main(["--model-dir", d, "--device", "cpu"] + args) == 0
    jax_server.main(["--model-dir", d] + args)
    assert {k: calls[-1][k] for k in FLEET_DEFAULTS} == {k: jax_calls[-1][k]
                                                        for k in FLEET_DEFAULTS}
    assert calls[-1]["replicas"] == 3 and calls[-1]["scale_cooldown_s"] == 5.0


# ------------------------------------------------------------ fleet serving


@pytest.fixture(scope="module")
def gen():
    """Tiny random weights, kernels x10 so that the model does not echo."""
    mc = get_preset("tiny")
    params = tf.init_params(mc, seed=0, device="cpu", dtype=torch.float32)
    params = {k: v * 10.0 if k.endswith(".kernel") else v for k, v in params.items()}
    return Generator(params, mc, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                     eos_token_ids=[], device="cpu")


class _Server:
    """``build_server`` on a thread, for one test."""

    def __init__(self, gen, **kw):
        self.httpd, self.engine = server.build_server(gen, host="127.0.0.1", port=0,
                                                      **{**GEOMETRY, **kw})
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.engine.close()
        self.thread.join(10)

    def request(self, method, path, body=None, raw=None):
        """-> (status, parsed JSON or text)."""
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=TIMEOUT)
        try:
            data = raw if raw is not None else (None if body is None else json.dumps(body))
            conn.request(method, path, body=data, headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            text = resp.read().decode()
            try:
                return resp.status, json.loads(text)
            except ValueError:
                return resp.status, text
        finally:
            conn.close()


def test_fleet_stats_metrics_flight_capacity_and_scale(gen):
    with _Server(gen, engine="continuous", flight_dir=None) as single:
        status, solo = single.request("POST", "/v1/generate", QUESTION)
        assert status == 200
        status, body = single.request("POST", "/v1/fleet/scale", {"replicas": 2})
        assert status == 404 and "fleet scaling needs --replicas > 1" in body["error"]
    with _Server(gen, replicas=2, max_replicas=3, autoscale="off",
                 migrate_on_retire=True, host_tier_mb=64) as srv:
        assert isinstance(srv.engine, EngineFleet) and len(srv.engine.replicas) == 2
        for _ in range(2):  # the repeat lands on the replica holding the prefix
            status, answer = srv.request("POST", "/v1/generate", QUESTION)
            assert status == 200 and answer == solo
        status, stats = srv.request("GET", "/v1/stats")
        assert status == 200 and stats["engine"] == "paged" and stats["replicas"] == 2
        assert set(stats["per_replica"]) == {"0", "1"} and "compile" not in stats
        assert stats["requests_completed"] == 2 and stats["requests_routed_prefix_affinity"] >= 1
        assert stats["device_memory_report"] == srv.engine.memory_breakdown()
        status, text = srv.request("GET", "/metrics")
        assert status == 200
        for rid in ("0", "1"):
            assert re.search(rf'^serving_replica_info\{{replica="{rid}",', text, re.M)
            assert re.search(rf'^serving_tokens_served_total\{{replica="{rid}"\}} ', text, re.M)
        assert "serving_requests_completed_total 2\n" in text
        assert 'serving_role_replicas{role="mixed"} 2\n' in text
        status, flight = srv.request("GET", "/v1/flight?limit=5")
        assert status == 200 and set(flight) == {"fleet", "replicas"}
        assert set(flight["replicas"]) == {"0", "1"}
        status, cap = srv.request("GET", "/v1/capacity")
        assert status == 200 and cap["autoscale"] == "off" and cap["decisions"] == []
        assert cap["replicas"] == 2 and cap["bounds"] == {"min_replicas": 1, "max_replicas": 3}
        for body, code in (({"replicas": 4}, 400), ({"replicas": 0}, 400), ({}, 400),
                           ({"replicas": 3}, 200), ({"replicas": 1}, 200)):
            status, resp = srv.request("POST", "/v1/fleet/scale", body)
            assert status == code, (body, resp)
            if code == 200:
                assert resp == {"replicas": body["replicas"]}
        status, stats = srv.request("GET", "/v1/stats")
        assert stats["replicas"] == 1 and stats["replicas_retired"] == 2
        assert stats["requests_completed"] == 2  # the retired replicas' counts stay
        status, answer = srv.request("POST", "/v1/generate", QUESTION)
        assert status == 200 and answer == solo


def test_disaggregated_server_hands_each_request_off(gen):
    """``--replicas 2 --replica-roles prefill,decode --host-tier-mb``: the
    prefill replica runs every prompt to its first token and hands it to
    the decode replica, with the answer of a single engine."""
    with _Server(gen, flight_dir=None) as single:
        status, solo = single.request("POST", "/v1/generate", QUESTION)
        assert status == 200
    with _Server(gen, replicas=2, replica_roles="prefill,decode", host_tier_mb=64,
                 autoscale="off") as srv:
        for _ in range(2):
            status, answer = srv.request("POST", "/v1/generate", QUESTION)
            assert status == 200 and answer == solo
        status, stats = srv.request("GET", "/v1/stats")
        pre, dec = stats["per_replica"]["0"], stats["per_replica"]["1"]
        assert (pre["role"], dec["role"]) == ("prefill", "decode")
        assert stats["role"] == "disaggregated" and stats["requests_handed_off"] == 2
        assert pre["decode_steps"] == 0 and pre["requests_completed"] == 0
        assert dec["requests_completed"] == 2 and dec["slots_migrated"] == 2


# ------------------------------------------------------------ live deployment


def _fresh(gen):
    """A Generator over copies of ``gen``'s weights: a swap re-points the
    Generator's own weights when its engine held them."""
    return Generator({k: v.clone() for k, v in gen.params.items()}, gen.config,
                     ByteChatMLTokenizer(), compute_dtype=torch.float32, eos_token_ids=[],
                     device="cpu")


def _publish_shifted(gen, publish_dir, step, run_id):
    """Publish the two first kernels shifted by 0.25, as a trainer would."""
    from llm_fine_tune_distributed_tpu_torch.train.checkpoints import frozen_fingerprint
    from llm_fine_tune_distributed_tpu_torch.train.publish import CheckpointPublisher

    names = sorted(k for k in gen.params if k.endswith(".kernel"))[:2]
    frozen = {k: v for k, v in gen.params.items() if k not in names}
    CheckpointPublisher(publish_dir).publish(
        step, {k: gen.params[k] + 0.25 for k in names}, frozen_fp=frozen_fingerprint(frozen),
        metrics={"eval_loss": 1.0}, run_id=run_id, hparams_digest="h", anomaly_clean=True)


@pytest.mark.parametrize("kw", [dict(engine="continuous"), dict(engine="paged"),
                                dict(engine="paged", replicas=2)],
                         ids=["continuous", "paged", "fleet"])
def test_deploy_rollback_and_lineage_routes(gen, kw, tmp_path):
    """POST /v1/deploy: a noop before any publish, then the publish swapped
    into every replica (the answer moves); POST /v1/deploy/rollback: 409
    before a deploy, then the pre-swap answer back; GET /v1/lineage: the
    deploy and the rollback with the manifest's run_id, joined with each
    generation's serving slice."""
    publish_dir = str(tmp_path / "publish")
    g = _fresh(gen)
    with _Server(g, publish_watch_dir=publish_dir, publish_poll_s=3600, **kw) as srv:
        replicas = getattr(srv.engine, "replicas", [srv.engine])
        status, before = srv.request("POST", "/v1/generate", QUESTION)
        assert status == 200
        status, body = srv.request("POST", "/v1/deploy")
        assert status == 200 and body["kind"] == "noop" and body["deployed_step"] == -1
        status, body = srv.request("POST", "/v1/deploy/rollback")
        assert status == 409 and "nothing to roll back to" in body["error"]
        _publish_shifted(g, publish_dir, 1, "run-7")
        status, body = srv.request("POST", "/v1/deploy")
        assert status == 200 and body["kind"] == "deploy" and body["step"] == 1
        assert body["run_id"] == "run-7" and body["replicas"] == len(replicas)
        assert [r.weight_generation for r in replicas] == [1] * len(replicas)
        status, after = srv.request("POST", "/v1/generate", QUESTION)
        assert status == 200 and after != before
        status, body = srv.request("POST", "/v1/deploy/rollback")
        assert status == 200 and body["kind"] == "rollback" and body["step"] == -1
        status, back = srv.request("POST", "/v1/generate", QUESTION)
        assert status == 200 and back == before
        status, lineage = srv.request("GET", "/v1/lineage")
        assert status == 200
        assert [r["kind"] for r in lineage["history"]] == ["deploy", "rollback"]
        assert lineage["generations"]["1"]["run_id"] == "run-7"
        assert lineage["weight_generations"] == [2] * len(replicas)
        assert lineage["generations"]["1"]["slo"]["completed"] >= 1
        assert set(lineage["serving"]) >= {"0", "1", "2"}
        assert srv.httpd.deploy_manager is not None


def test_deploy_routes_404_without_a_watch_dir(gen):
    with _Server(gen, engine="continuous") as srv:
        for path in ("/v1/deploy", "/v1/deploy/rollback"):
            status, body = srv.request("POST", path)
            assert status == 404 and "--publish-watch-dir" in body["error"]
