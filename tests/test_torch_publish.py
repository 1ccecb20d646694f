"""The trainer's half of live deployment in the port (``train/publish.py``
driven by ``SFTTrainer``, gated by ``observe/trainplane.py``) against the
JAX package's, on the ``tiny`` preset:

- the anomaly sentinels and the telemetry fire, gate and count as the JAX
  ones do on the same metric streams (the cases of ``tests/test_trainplane.py``
  without its HTTP control plane, which is not ported);
- a training run publishes after every save, each manifest stamped with the
  run's id, its hparams digest and a clean anomaly window;
- a NaN loss at a logged step flips ``anomaly_clean`` to false, and under
  ``publish_require_clean`` suppresses the publish;
- the same run trained by both packages (the same model directory and rows)
  publishes the same steps with manifests of the same keys, schema, sizes,
  metrics and stamps, weights within 1e-5 of each other, and frozen
  fingerprints that pass both packages' checks. What differs, and why:
  ``run_id`` and ``published_unix`` (per run), ``weights_file`` (the port
  writes safetensors), ``hparams_digest`` (the two configs have different
  field sets) and ``weight_fingerprint`` (a digest of bytes that two
  frameworks round differently in the last place).
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.config import TrainConfig
from llm_fine_tune_distributed_tpu_torch.observe.trainplane import (
    AnomalySentinels,
    TrainTelemetry,
    hparams_digest,
)
from llm_fine_tune_distributed_tpu_torch.train.checkpoints import verify_fingerprint
from llm_fine_tune_distributed_tpu_torch.train.publish import (
    list_published,
    load_manifest,
    load_weights,
)
from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _jax_trainplane():
    from llm_fine_tune_distributed_tpu.observe import trainplane

    return trainplane


# ------------------------------------------------------------- sentinels


def _spike_stream():
    rng = np.random.RandomState(0)
    return ([("loss", 1.0 + 0.01 * rng.randn()) for _ in range(20)]
            + [("loss", 100.0), ("loss", 1.0), ("loss", 100.0)])


SENTINEL_SCRIPTS = {
    "non_finite": (dict(), [("loss", float("nan")), ("grad_norm", float("inf"))]),
    "loss_spike": (dict(band_sigma=6.0, warmup=8), _spike_stream()),
    "wild_first_value": (dict(warmup=8), [("loss", 50.0)]),
    "grad_explosion": (dict(warmup=4), [("grad_norm", 0.5)] * 5 + [("grad_norm", 500.0)]),
    "flat_warmup": (dict(warmup=4), [("loss", 2.0)] * 7 + [("loss", 2.001)]),
}


@pytest.mark.parametrize("script", sorted(SENTINEL_SCRIPTS))
def test_sentinels_fire_as_the_jax_ones(script):
    kw, stream = SENTINEL_SCRIPTS[script]

    def run(cls):
        s = cls(**kw)
        fired = [s.observe(i, **{name: value}) for i, (name, value) in enumerate(stream, 1)]
        return fired, s.snapshot(), [s.clean_since(k) for k in (1, len(stream), len(stream) + 1)]

    port, ref = run(AnomalySentinels), run(_jax_trainplane().AnomalySentinels)
    assert port == ref
    if script == "loss_spike":
        assert port[0][-3:] == [["loss_spike"], [], ["loss_spike"]]
    if script in ("wild_first_value", "flat_warmup"):
        assert port[1]["total"] == 0


def test_band_sigma_must_be_positive():
    with pytest.raises(ValueError):
        AnomalySentinels(band_sigma=0.0)


def test_telemetry_feeds_flight_status_gate_and_counters():
    def run(cls):
        t = cls(hparams={"lr": 1e-4}, anomaly_window_steps=10)
        t.update(total_steps=100, epochs=2)
        out = [t.on_step(5, {"loss": 1.5, "grad_norm": 0.3, "learning_rate": 1e-4}),
               t.on_step(10, {"loss": 1.4, "eval_loss": 1.3, "steps_per_second": 2.0}),
               t.on_step(13, {"loss": float("nan")})]
        gates = [t.publish_clean(s) for s in (12, 22, 23)]
        t.note_publish(8, clean=True, fingerprint="abc")
        t.note_publish(16, clean=False, skipped=True)
        t.note_checkpoint(8, 0.5)
        st = t.status()
        kinds = [e["kind"] for e in t.recorder.events()]
        return (out, gates, st["step"], st["counters"], st["eta_s"], st["publishes"],
                st["checkpoints"], kinds, t.hparams_digest)

    port, ref = run(TrainTelemetry), run(_jax_trainplane().TrainTelemetry)
    assert port == ref
    out, gates, step, counters, eta, *_ = port
    assert out[2] == ["non_finite"] and gates == [False, False, True]
    assert counters["evals"] == 1 and counters["publishes"] == 1
    assert counters["publishes_skipped_dirty"] == 1 and counters["checkpoints_saved"] == 1
    assert eta == pytest.approx(43.5)


def test_hparams_digest_equals_the_jax_digest():
    a = {"lr": 1e-4, "bs": 8, "name": "x", "none": None}
    assert hparams_digest(a) == _jax_trainplane().hparams_digest(a)
    assert hparams_digest(a) == hparams_digest(dict(reversed(list(a.items()))))
    assert hparams_digest(a) != hparams_digest({**a, "lr": 2e-4})


# ------------------------------------------------------- trainer publishes


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """48 rows as JSONL (the port) and parquet (JAX), and a tiny model
    directory of JAX-initialized f32 weights."""
    import jax
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.data.convert import convert_jsonl_to_parquet
    from llm_fine_tune_distributed_tpu.models import configs as jax_configs
    from llm_fine_tune_distributed_tpu.models import hf_io as jax_hf_io
    from llm_fine_tune_distributed_tpu.models import transformer as jax_tf

    tmp = tmp_path_factory.mktemp("publish")
    data = tmp / "data"
    data.mkdir()
    with open(os.path.join(ROOT, "data", "final_qa_data_unique.jsonl")) as f:
        lines = [next(f) for _ in range(48)]
    (data / "qa.jsonl").write_text("".join(lines))
    convert_jsonl_to_parquet(str(data / "qa.jsonl"), str(data / "qa.parquet"), verbose=False)
    mc = jax_configs.get_preset("tiny")
    params = jax_tf.init_params(jax.random.PRNGKey(5), mc, dtype=jnp.float32)
    jax_hf_io.save_hf_checkpoint(jax.device_get(params), str(tmp / "model"))
    (tmp / "model" / "config.json").write_text(json.dumps(jax_configs.to_hf_dict(mc)))
    return tmp


def _recipe(workdir, out, **kw):
    base = dict(model_name=str(workdir / "model"), model_preset="tiny",
                tokenizer_path="byte-chatml", data_dir=str(workdir / "data"),
                dataset_file="qa.jsonl", output_dir=str(workdir / out), epochs=1,
                per_device_batch_size=2, gradient_accumulation_steps=2, eval_steps=4,
                save_steps=4, logging_steps=2, max_seq_length=128, system_prompt="You are an expert.",
                compute_dtype="float32", publish_dir=str(workdir / out / "publish"),
                checkpoint_trainable_only=True, use_native_loader=False)
    base.update(kw)
    return base


def _nan_at_step(trainer, bad_step):
    """One step's loss comes back NaN: divergence without touching the model."""
    real = trainer.train_step
    holder = {"n": 0}

    def wrapped(state, batch):
        state, metrics = real(state, batch)
        holder["n"] += 1
        if holder["n"] == bad_step:
            metrics = dict(metrics)
            metrics["loss"] = torch.tensor(float("nan"))
        return state, metrics

    trainer.train_step = wrapped


def test_every_save_publishes_a_clean_stamped_manifest(workdir):
    trainer = SFTTrainer(TrainConfig(**_recipe(workdir, "clean")), device="cpu")
    trainer.train()
    pubs = list_published(str(workdir / "clean" / "publish"))
    assert [s for s, _ in pubs] == [4, 8, 10]
    for step, path in pubs:
        m = load_manifest(path)
        assert m["run_id"] == trainer.telemetry.run_id
        assert m["hparams_digest"] == trainer.telemetry.hparams_digest
        assert m["anomaly_clean"] is True and m["step"] == step
        assert set(load_weights(path, m)) == set(trainer.state.trainable)
    st = trainer.telemetry.status()
    assert st["counters"]["publishes"] == 3 and st["counters"]["checkpoints_saved"] == 2
    assert trainer.last_publish["step"] == 10 and trainer.last_publish["bytes"] > 0


def test_injected_nan_flips_anomaly_clean(workdir):
    trainer = SFTTrainer(TrainConfig(**_recipe(workdir, "nan", anomaly_window_steps=100,
                                               eval_steps=100)), device="cpu")
    _nan_at_step(trainer, 2)  # a logging boundary
    trainer.train()
    assert trainer.telemetry.sentinels.snapshot()["counts"]["non_finite"] >= 1
    assert any(e["kind"] == "anomaly" and e["anomaly"] == "non_finite"
               for e in trainer.telemetry.recorder.events())
    pubs = list_published(str(workdir / "nan" / "publish"))
    assert pubs and all(load_manifest(p)["anomaly_clean"] is False for _, p in pubs)


def test_publish_require_clean_suppresses_dirty_publish(workdir):
    trainer = SFTTrainer(TrainConfig(**_recipe(workdir, "strict", anomaly_window_steps=1000,
                                               eval_steps=100, publish_require_clean=True)),
                         device="cpu")
    _nan_at_step(trainer, 2)
    trainer.train()
    assert list_published(str(workdir / "strict" / "publish")) == []
    st = trainer.telemetry.status()
    assert st["counters"]["publishes_skipped_dirty"] >= 1 and st["counters"]["publishes"] == 0


def test_publish_failure_is_not_fatal(workdir, capsys):
    """A publish directory that cannot be written logs and trains on."""
    blocker = workdir / "blocked_publish"
    blocker.write_text("a file where the publish directory should be")
    trainer = SFTTrainer(TrainConfig(**_recipe(workdir, "blocked", publish_dir=str(blocker))),
                         device="cpu")
    summary = trainer.train()
    assert summary["final_train_loss"] is not None
    assert "checkpoint publish for step" in capsys.readouterr().out


def test_manifests_equal_the_jax_trainers(workdir):
    from llm_fine_tune_distributed_tpu.config import MeshConfig as JaxMeshConfig
    from llm_fine_tune_distributed_tpu.config import TrainConfig as JaxTrainConfig
    from llm_fine_tune_distributed_tpu.train import checkpoints as jax_ck
    from llm_fine_tune_distributed_tpu.train import publish as jax_publish
    from llm_fine_tune_distributed_tpu.train.trainer import SFTTrainer as JaxSFTTrainer

    jrecipe = _recipe(workdir, "jax_run", dataset_file="qa.parquet",
                      mesh=JaxMeshConfig(data=1, fsdp=1), checkpoint_async_snapshot=False)
    JaxSFTTrainer(JaxTrainConfig(**jrecipe)).train()
    port = SFTTrainer(TrainConfig(**_recipe(workdir, "port_run")), device="cpu")
    port.train()
    jpubs = jax_publish.list_published(jrecipe["publish_dir"])
    ppubs = list_published(str(workdir / "port_run" / "publish"))
    assert [s for s, _ in ppubs] == [s for s, _ in jpubs] and ppubs
    for (_, ppath), (_, jpath) in zip(ppubs, jpubs):
        pm, jm = load_manifest(ppath), jax_publish.load_manifest(jpath)
        assert set(pm) == set(jm)
        for key in ("schema", "step", "num_leaves", "bytes", "anomaly_clean"):
            assert pm[key] == jm[key], key
        assert set(pm["metrics"]) == set(jm["metrics"])
        for k, v in jm["metrics"].items():
            assert math.isclose(pm["metrics"][k], v, rel_tol=1e-4), k
        jfp = {k.replace("/", "."): v for k, v in jm["frozen_fp"].items()}
        verify_fingerprint(jfp, pm["frozen_fp"])
        jax_ck.verify_fingerprint(pm["frozen_fp"], jfp)
        pw = load_weights(ppath, pm)
        jw = {k.replace("/", "."): v for k, v in jax_publish.load_weights(jpath, jm).items()}
        assert set(pw) == set(jw)
        for k, v in jw.items():
            np.testing.assert_allclose(pw[k].numpy(), v, rtol=1e-4, atol=1e-5, err_msg=k)
