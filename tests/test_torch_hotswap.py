"""The port's live deployment (``train/publish.py``, ``infer/deploy.py`` and
the engines' tick-boundary swap) against the JAX package's, case by case as
``tests/test_hotswap.py`` pins them, on the ``tiny`` preset in f32 with the
same weights in both (kernels x10, so that the tiny model answers rather
than echoing):

- the publish protocol: atomic writes, the manifest as the commit point,
  torn or unloadable publishes skipped, keep-last retention, and payload
  digests equal to the JAX package's for the same bytes;
- an identity swap gives the same greedy tokens on both slot engines, with
  parameter shapes, dtypes and devices unchanged and no kernel built (the
  JAX "zero recompiles"), and the JAX engines give the same tokens;
- a request in flight across a swap finishes on the old weights (its tokens
  equal the base model's solo run) and settles under the old generation;
- the paged prefix cache is dropped on a real change only, as the JAX
  engine's is;
- a rollback restores the port's own pre-swap tokens, on a float and on an
  int8 KV pool (the JAX case fails: its tiny model echoes, and its int8
  pool keeps stale block scales); the poller does not redeploy the step it
  fled;
- a crash during a staged swap recovers into one application of it; a
  terminal engine refuses a swap; 16 clients across a rolling fleet swap
  lose nothing;
- a published kernel is re-quantized into a resident int8 leaf, with the
  JAX package's codes, and an unreconcilable one fails the swap only; into
  a resident NF4 leaf likewise (the JAX file's
  ``test_swap_requantizes_into_resident_nf4``);
- beyond the JAX file: the watcher's eval gate and fingerprint refusals,
  the canary that rejects a failing replica 0 before replica 1 swaps, the
  lineage records, the adapter registry's ``rebind``, host-tier entries of
  another generation missing, and the replaced leaves freed when the
  engine owned its Generator.

A card-only case swaps and rolls back on the GPU: ``python -m pytest
--noconftest -m cuda tests/test_torch_hotswap.py``.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer.deploy import CheckpointWatcher, HotSwapManager
from llm_fine_tune_distributed_tpu_torch.infer.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from llm_fine_tune_distributed_tpu_torch.infer.fleet import EngineFleet
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
from llm_fine_tune_distributed_tpu_torch.observe.slo import CanaryJudge
from llm_fine_tune_distributed_tpu_torch.ops import _build
from llm_fine_tune_distributed_tpu_torch.ops.int8 import maybe_quantize, quantize_int8
from llm_fine_tune_distributed_tpu_torch.train.checkpoints import frozen_fingerprint
from llm_fine_tune_distributed_tpu_torch.train.publish import (
    MANIFEST_NAME,
    WEIGHTS_NAME,
    CheckpointPublisher,
    atomic_write_bytes,
    list_published,
    load_manifest,
    load_weights,
    parse_step,
    step_dir_name,
    weights_digest,
)

GREEDY = GenerationConfig(max_new_tokens=6, do_sample=False)
LONG = GenerationConfig(max_new_tokens=32, do_sample=False)
TIMEOUT = 120
KINDS = ("continuous", "paged")


def _x10(params):
    return {k: v * 10.0 if k.endswith(".kernel") else v for k, v in params.items()}


@pytest.fixture(scope="module")
def port_gen():
    mc = get_preset("tiny")
    params = _x10(tf.init_params(mc, seed=0, device="cpu", dtype=torch.float32))
    return Generator(params, mc, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                     eos_token_ids=[], device="cpu")


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port's Generator on the same x10 weights (JAX
    PRNGKey(0)), with each package's engines."""
    import jax
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer as JaxTok
    from llm_fine_tune_distributed_tpu.infer import GenerationConfig as JaxConfig
    from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator
    from llm_fine_tune_distributed_tpu.infer import engine as jax_engine
    from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_get_preset
    from llm_fine_tune_distributed_tpu.models.transformer import init_params as jax_init_params
    from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax

    jmc = jax_get_preset("tiny")
    jparams = jax_init_params(jax.random.PRNGKey(0), jmc, dtype=jnp.float32)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 10.0 if path[-1].key == "kernel" else x, jparams)
    jgen = JaxGenerator(jparams, jmc, JaxTok(), compute_dtype=jnp.float32, eos_token_ids=[])
    mc = get_preset("tiny")
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jparams)).items()}
    gen = Generator(params_from_jax(flat, mc), mc, ByteChatMLTokenizer(),
                    compute_dtype=torch.float32, eos_token_ids=[], device="cpu")
    return {"jax": dict(gen=jgen, config=JaxConfig, continuous=jax_engine.ContinuousBatchingEngine,
                        paged=jax_engine.PagedContinuousBatchingEngine, sep="/"),
            "port": dict(gen=gen, config=GenerationConfig, continuous=ContinuousBatchingEngine,
                         paged=PagedContinuousBatchingEngine, sep=".")}


def _make(side, kind, gen=None, **kw):
    kw.setdefault("restart_backoff_s", 0.01)
    kw.setdefault("restart_backoff_max_s", 0.02)
    gen = gen if gen is not None else side["gen"]
    if kind == "paged":
        return side["paged"](gen, slots=4, buf_len=96, prompt_bucket=16, block_len=16,
                             prefill_chunk=32, **kw)
    return side["continuous"](gen, slots=4, buf_len=96, prompt_bucket=16, **kw)


def _port_engine(gen, kind, **kw):
    return _make({"paged": PagedContinuousBatchingEngine,
                  "continuous": ContinuousBatchingEngine, "gen": gen}, kind, **kw)


def _close(eng):
    if hasattr(eng, "close"):  # the JAX engines have no close(); their workers are daemons
        eng.close()


def _prompt(text="hello world"):
    return ByteChatMLTokenizer().encode(text)


def _names(gen, n=2):
    """The first ``n`` kernels (sorted), as a trainer's fine-tuned set."""
    return sorted(k for k in gen.params if k.endswith(".kernel"))[:n]


def _split(gen, n=2):
    """(trainable host copies, frozen fingerprint): the flat shape a
    trainer's publish carries."""
    keys = _names(gen, n)
    trainable = {k: gen.params[k].detach().clone() for k in keys}
    frozen = {k: v for k, v in gen.params.items() if k not in trainable}
    return trainable, frozen_fingerprint(frozen)


def _jax_split(jgen, n=2):
    from llm_fine_tune_distributed_tpu.utils.tree import flatten_dict

    flat = flatten_dict(jgen.params)
    keys = sorted(k for k in flat if k.endswith("kernel"))[:n]
    return {k: np.asarray(flat[k]) for k in keys}


def _shift(weights, delta=0.25):
    return {k: v + delta for k, v in weights.items()}


def _solo(gen, prompt, cfg):
    return list(gen.generate_ids(prompt, cfg))


def _geometry(params):
    return {k: (tuple(v.shape), v.dtype, v.device) for k, v in params.items()}


# ------------------------------------------------------- publish protocol


def test_atomic_write_replaces_never_tears(tmp_path):
    p = str(tmp_path / "blob.bin")
    atomic_write_bytes(p, b"first")
    atomic_write_bytes(p, b"second")
    assert open(p, "rb").read() == b"second"
    assert os.listdir(tmp_path) == ["blob.bin"]  # no temp litter


def test_manifest_is_the_commit_point(tmp_path):
    """The port's manifest has the JAX schema and keys, and its digest is
    the JAX package's for the same leaves."""
    from llm_fine_tune_distributed_tpu.train.publish import CheckpointPublisher as JaxPublisher

    pub = CheckpointPublisher(str(tmp_path / "port"), keep_last=3)
    trainable = {"a.kernel": torch.ones((2, 2))}
    path = pub.publish(7, trainable, frozen_fp={"b": np.zeros(4, np.float32)})
    assert parse_step(os.path.basename(path)) == 7
    assert list_published(str(tmp_path / "port")) == [(7, path)]
    manifest = load_manifest(path)
    assert manifest["step"] == 7 and manifest["weights_file"] == WEIGHTS_NAME
    assert manifest["weight_fingerprint"] == weights_digest(trainable)
    loaded = load_weights(path, manifest)
    assert set(loaded) == {"a.kernel"}
    assert torch.equal(loaded["a.kernel"], trainable["a.kernel"])
    jpath = JaxPublisher(str(tmp_path / "jax")).publish(
        7, {"a.kernel": np.ones((2, 2), np.float32)}, frozen_fp={"b": np.zeros(4, np.float32)})
    jmanifest = load_manifest(jpath)
    assert set(manifest) == set(jmanifest)
    assert manifest["weight_fingerprint"] == jmanifest["weight_fingerprint"]
    for key in ("schema", "step", "num_leaves", "bytes", "frozen_fp", "metrics"):
        assert manifest[key] == jmanifest[key], key
    # the port reads the JAX package's npz publish too
    jw = load_weights(jpath, jmanifest)
    assert torch.equal(jw["a.kernel"], trainable["a.kernel"])
    # a dir whose manifest is gone is invisible, weights notwithstanding
    os.unlink(os.path.join(path, MANIFEST_NAME))
    assert list_published(str(tmp_path / "port")) == []


def test_torn_manifest_reads_as_no_publish(tmp_path):
    pub = CheckpointPublisher(str(tmp_path), keep_last=3)
    pub.publish(1, {"w": torch.ones(3)}, frozen_fp={})
    path = pub.publish(2, {"w": torch.full((3,), 2.0)}, frozen_fp={})
    with open(os.path.join(path, MANIFEST_NAME), "w") as f:
        f.write('{"schema": 1, "step": 2, "weights_fi')
    dep = CheckpointWatcher(str(tmp_path), verify_frozen=False).check()
    assert dep is not None and dep["step"] == 1


def test_unloadable_weights_skipped(tmp_path):
    pub = CheckpointPublisher(str(tmp_path), keep_last=3)
    pub.publish(1, {"w": torch.ones(3)}, frozen_fp={})
    path = pub.publish(2, {"w": torch.full((3,), 2.0)}, frozen_fp={})
    os.unlink(os.path.join(path, WEIGHTS_NAME))
    dep = CheckpointWatcher(str(tmp_path), verify_frozen=False).check()
    assert dep is not None and dep["step"] == 1


def test_retention_keeps_last_k(tmp_path):
    pub = CheckpointPublisher(str(tmp_path), keep_last=3)
    for step in range(1, 6):
        pub.publish(step, {"w": torch.full((2,), float(step))}, frozen_fp={})
    assert [s for s, _ in list_published(str(tmp_path))] == [3, 4, 5]
    assert not os.path.exists(str(tmp_path / step_dir_name(1)))
    assert CheckpointWatcher(str(tmp_path), verify_frozen=False).check()["step"] == 5


def test_identical_payload_same_fingerprint():
    from llm_fine_tune_distributed_tpu.train.publish import weights_digest as jax_digest

    w = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
         "q": np.arange(-3, 3, dtype=np.int8)}
    t = {k: torch.from_numpy(v.copy()) for k, v in w.items()}
    assert weights_digest(t) == weights_digest(w) == jax_digest(w)
    assert weights_digest({k: v.clone() for k, v in t.items()}) == weights_digest(t)
    assert weights_digest({"a": t["a"] + 1e-3, "q": t["q"]}) != weights_digest(t)


# --------------------------------------------------- engine tick-boundary


@pytest.mark.parametrize("kind", KINDS)
def test_identity_swap_bit_identical_no_rebuilds(pair, kind, tmp_path):
    """Same values in, same greedy tokens out, the JAX engines' tokens too;
    the swap changes no parameter's shape, dtype or device and builds no
    kernel."""
    jax_side, port = pair["jax"], pair["port"]
    prompt = _prompt()
    jeng = _make(jax_side, kind)
    jbefore = jeng.submit(prompt, jax_side["config"](max_new_tokens=6, do_sample=False))
    jeng.request_weight_swap(_jax_split(jax_side["gen"]), fingerprint="fp", step=1, timeout=60)
    jafter = jeng.submit(prompt, jax_side["config"](max_new_tokens=6, do_sample=False))

    engine = _make(port, kind)
    before = engine.submit(prompt, GREEDY)
    geometry, builds = _geometry(engine.params), dict(_build.build_log)
    trainable, frozen_fp = _split(port["gen"])
    CheckpointPublisher(str(tmp_path)).publish(1, trainable, frozen_fp=frozen_fp)
    mgr = HotSwapManager(engine, CheckpointWatcher(str(tmp_path),
                                                   base_params=lambda: engine.params))
    res = mgr.poll_once()
    assert res is not None and res["step"] == 1 and engine.weight_generation == 1
    assert mgr.poll_once() is None  # nothing newer
    after = engine.submit(prompt, GREEDY)
    assert after == before == jbefore == jafter
    assert _geometry(engine.params) == geometry
    assert _build.build_log == builds
    snap = engine.stats_snapshot()
    assert snap["weight_swaps"] == 1 and snap["weight_generation"] == 1
    kinds = [e["kind"] for e in engine.recorder.events()]
    assert "weight_swap_begin" in kinds and "weight_swap" in kinds
    _close(engine)


@pytest.mark.parametrize("kind", KINDS)
def test_inflight_request_finishes_on_old_generation(port_gen, kind):
    """A stream in flight when the swap is staged gets every token, equal to
    the base model's solo run, and settles under generation 0; a request
    after the swap settles under generation 1 with the new weights' tokens."""
    engine = _port_engine(port_gen, kind)
    trainable, _ = _split(port_gen)
    prompt = _prompt("stream across the swap boundary")
    base = _solo(port_gen, prompt, LONG)
    box, started = {}, threading.Event()

    def run():
        toks = []
        for t in engine.stream(prompt, LONG, timeout=TIMEOUT):
            toks.append(t)
            started.set()
        box["tokens"] = toks

    th = threading.Thread(target=run)
    th.start()
    assert started.wait(30)
    res = engine.request_weight_swap(_shift(trainable), fingerprint="changed", step=1,
                                     timeout=60)
    th.join(60)
    assert not th.is_alive()
    assert box["tokens"] == base
    assert res["weight_generation"] == 1
    done = engine.submit_full(prompt, GREEDY, timeout=TIMEOUT)
    assert done.weight_generation == 1
    assert [e["kind"] for e in engine.recorder.events()].count("weight_swap") == 1
    _close(engine)


def test_prefix_cache_flushes_on_real_change_then_rebuilds(pair):
    """The JAX engine's sequence of prefix reuse across a first swap, an
    identity republish and a real change, on the port's paged engine."""

    def script(side):
        engine = _make(side, "paged")
        cfg = side["config"](max_new_tokens=6, do_sample=False)
        prompt = _prompt("the quick brown fox jumps over the lazy dog")
        if side["sep"] == "/":
            trainable = _jax_split(side["gen"])
        else:
            trainable, _ = _split(side["gen"])

        def reused(fn):
            a = engine.stats_snapshot()["prefix_tokens_reused"]
            fn()
            return engine.stats_snapshot()["prefix_tokens_reused"] - a

        def submit():
            engine.submit(prompt, cfg)

        out = [reused(submit), reused(submit)]
        engine.request_weight_swap(trainable, fingerprint="fp-same", step=1, timeout=60)
        out += [reused(submit), reused(submit)]
        engine.request_weight_swap(trainable, fingerprint="fp-same", step=2, timeout=60)
        out += [reused(submit)]
        engine.request_weight_swap(_shift(trainable), fingerprint="fp-new", step=3, timeout=60)
        out += [reused(submit), reused(submit)]
        flushes = [e for e in engine.recorder.events() if e["kind"] == "prefix_cache_invalidated"]
        _close(engine)
        return out, [f["entries"] > 0 for f in flushes]

    port, ref = script(pair["port"]), script(pair["jax"])
    assert port == ref
    reuse, flushes = port
    assert reuse[0] == 0 and reuse[1] > 0
    assert reuse[2] == 0 and reuse[3] > 0  # the first swap flushes (no digest at boot)
    assert reuse[4] > 0  # an identity republish keeps the cache
    assert reuse[5] == 0 and reuse[6] > 0  # a real change flushes, then rebuilds
    assert flushes == [True, True]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_rollback_restores_prior_outputs(port_gen, kv_quant, tmp_path):
    """A fleet of two paged replicas: a deploy of the same values keeps the
    tokens, a real change moves them, and the rollback restores the port's
    own pre-swap tokens bit for bit, on every replica in lockstep. On an
    int8 pool this holds because the invalidation zeroes the stale block
    scales."""
    fleet = EngineFleet([_port_engine(port_gen, "paged", kv_quant=kv_quant) for _ in range(2)],
                        routing="prefix")
    prompt = _prompt()
    base = fleet.submit(prompt, GREEDY)
    trainable, frozen_fp = _split(port_gen)
    pub = CheckpointPublisher(str(tmp_path))
    pub.publish(1, trainable, frozen_fp=frozen_fp)
    watcher = CheckpointWatcher(str(tmp_path), base_params=lambda: fleet.replicas[0].params)
    mgr = HotSwapManager(fleet, watcher)
    assert mgr.poll_once()["step"] == 1
    assert fleet.submit(prompt, GREEDY) == base
    pub.publish(2, _shift(trainable), frozen_fp=frozen_fp)
    res = mgr.poll_once()
    assert res["step"] == 2 and res["cache_invalidated"]
    assert fleet.submit(prompt, GREEDY) != base
    rb = mgr.rollback()
    assert rb["kind"] == "rollback" and rb["step"] == 1
    assert fleet.submit(prompt, GREEDY) == base
    assert [e.weight_generation for e in fleet.replicas] == [3, 3]
    snap = fleet.stats_snapshot()
    assert snap["weight_rollbacks"] == 2 and snap["weight_generation"] == 3
    assert mgr.poll_once() is None  # the fled step is held
    fresh = _port_engine(port_gen, "continuous")
    with pytest.raises(RuntimeError):
        HotSwapManager(fresh, watcher).rollback()
    _close(fresh)
    fleet.close()


@pytest.mark.parametrize("kind", KINDS)
def test_crash_during_swap_recovers_consistent(port_gen, kind):
    """The drain tick of a staged swap fails: the in-flight request fails,
    the engine restarts in-process, and the swap applies once on the new
    generation of the worker."""
    engine = _port_engine(port_gen, kind)
    trainable, _ = _split(port_gen)
    prompt = _prompt("crash mid drain")
    started, errors = threading.Event(), []

    def run():
        try:
            for _ in engine.stream(prompt, LONG, timeout=60):
                started.set()
        except Exception as e:  # the injected crash fails this one
            started.set()
            errors.append(e)

    th = threading.Thread(target=run)
    th.start()
    assert started.wait(30)
    engine.faults.fail_decode_next(1)
    res = engine.request_weight_swap(_shift(trainable), fingerprint="post-crash", step=1,
                                     timeout=60)
    th.join(60)
    assert res["weight_generation"] == 1 and engine.weight_generation == 1
    assert engine.healthy
    assert engine.stats_snapshot()["weight_swaps"] == 1
    assert engine.submit(prompt, GREEDY) == _solo_after(port_gen, engine, prompt)
    _close(engine)


def _solo_after(gen, engine, prompt):
    """The engine's current weights' solo run."""
    g = Generator(engine.params, gen.config, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                  eos_token_ids=[], device="cpu")
    return _solo(g, prompt, GREEDY)


def test_swap_rejected_on_terminal_engine(port_gen):
    engine = _port_engine(port_gen, "continuous", circuit_threshold=1)
    trainable, _ = _split(port_gen)
    engine.faults.fail_decode_next(10)
    with pytest.raises(Exception):
        engine.submit(_prompt(), GREEDY, timeout=TIMEOUT)
    deadline = time.monotonic() + 10
    while engine.healthy and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not engine.healthy
    with pytest.raises(Exception):
        engine.request_weight_swap(trainable, timeout=5)
    _close(engine)


def test_swap_under_concurrent_load_drops_nothing(port_gen, tmp_path):
    """16 clients on a 2-replica fleet while a rolling swap lands: no failed
    request, both replicas on generation 1, no kernel built."""
    fleet = EngineFleet([_port_engine(port_gen, "paged") for _ in range(2)], routing="prefix")
    prompts = [_prompt(f"client {i} says hi") for i in range(16)]
    builds = dict(_build.build_log)
    trainable, frozen_fp = _split(port_gen)
    CheckpointPublisher(str(tmp_path)).publish(1, trainable, frozen_fp=frozen_fp)
    mgr = HotSwapManager(fleet, CheckpointWatcher(
        str(tmp_path), base_params=lambda: fleet.replicas[0].params))
    errors, done = [], []

    def client(i):
        try:
            for _ in range(3):
                assert len(fleet.submit(prompts[i], GREEDY, timeout=TIMEOUT)) == 6
            done.append(i)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((i, e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    swap = mgr.poll_once()
    for t in threads:
        t.join(180)
    assert not errors, errors
    assert len(done) == 16 and swap is not None and swap["step"] == 1
    assert [e.weight_generation for e in fleet.replicas] == [1, 1]
    assert fleet.stats_snapshot()["requests_failed"] == 0
    assert _build.build_log == builds
    fleet.close()


# ----------------------------------------- quantized-resident swap


def _int8_gen(port_gen):
    params = maybe_quantize(dict(port_gen.params), "int8")
    return Generator(params, port_gen.config, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                     eos_token_ids=[], device="cpu")


def _layer0_kernels(port_gen):
    return sorted(k for k in port_gen.params
                  if ".layers.0." in k and k.endswith(".kernel") and "gate" not in k)


def test_swap_requantizes_into_resident_int8(port_gen):
    """A published plain kernel lands as the resident int8 codes and scale,
    the codes equal to the JAX package's quantizer's; shapes, dtypes and
    devices unchanged, and the engine still serves."""
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.ops.int8 import quantize_int8 as jax_quantize_int8

    gen = _int8_gen(port_gen)
    engine = _port_engine(gen, "paged", kv_quant="int8")
    prompt = _prompt()
    assert engine.submit(prompt, GREEDY)
    geometry = _geometry(engine.params)
    published = {k: port_gen.params[k] * 1.5 for k in _layer0_kernels(port_gen)[:2]}
    res = engine.request_weight_swap(published, fingerprint="fp-requant", step=1, timeout=60)
    assert res["weight_generation"] == 1 and res["updated_leaves"] == 4
    assert _geometry(engine.params) == geometry
    for name, w in published.items():
        want = quantize_int8(w)
        jwant = jax_quantize_int8(jnp.asarray(w.numpy()))
        assert torch.equal(engine.params[f"{name}_int8"], want["int8"])
        np.testing.assert_array_equal(engine.params[f"{name}_int8"].numpy(),
                                      np.asarray(jwant["int8"]))
        np.testing.assert_allclose(engine.params[f"{name}_int8_scale"].numpy(),
                                   np.asarray(jwant["int8_scale"]), rtol=1e-6)
    assert engine.submit(prompt, GREEDY)
    _close(engine)


def test_swap_requantizes_into_resident_nf4(port_gen):
    """The same translation for an NF4-resident engine (``--quantize
    nf4``): the published kernel lands as packed NF4 codes at the resident
    block size, equal to the JAX package's quantizer's, and the engine
    still serves."""
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.ops.nf4 import quantize_nf4 as jax_quantize_nf4

    gen = Generator(maybe_quantize(dict(port_gen.params), "nf4"), port_gen.config,
                    ByteChatMLTokenizer(), compute_dtype=torch.float32, eos_token_ids=[],
                    device="cpu")
    engine = _port_engine(gen, "continuous")
    prompt = _prompt()
    assert engine.submit(prompt, GREEDY)
    geometry = _geometry(engine.params)
    name = _layer0_kernels(port_gen)[0]
    w = port_gen.params[name] * 1.5
    res = engine.request_weight_swap({name: w}, fingerprint="fp-nf4", step=1, timeout=60)
    assert res["weight_generation"] == 1
    assert _geometry(engine.params) == geometry
    jwant = jax_quantize_nf4(jnp.asarray(w.numpy()))
    for suffix, want in jwant.items():
        np.testing.assert_array_equal(engine.params[f"{name}_{suffix}"].numpy(),
                                      np.asarray(want), err_msg=suffix)
    assert engine.submit(prompt, GREEDY)
    _close(engine)


def test_swap_rejects_unreconcilable_published_leaf(port_gen):
    """A published leaf that cannot become the resident int8 layout fails
    the swap with a message naming the mode; the engine keeps generation 0
    and serves."""
    engine = _port_engine(_int8_gen(port_gen), "paged", kv_quant="int8")
    prompt = _prompt()
    before = engine.submit(prompt, GREEDY)
    with pytest.raises(RuntimeError, match="--quantize int8"):
        engine.request_weight_swap({_layer0_kernels(port_gen)[0]: torch.zeros(8, 8)},
                                   fingerprint="fp-bad", step=1, timeout=60)
    assert engine.weight_generation == 0 and engine.healthy
    assert engine.submit(prompt, GREEDY) == before
    _close(engine)


# ------------------------------------------------- watcher, canary, lineage


def test_watcher_refuses_worse_eval_and_foreign_base(port_gen, tmp_path):
    """After a deploy with eval_loss 1.0, a publish with 2.0 is refused by
    the eval gate and one trained against another base by the fingerprint
    check, each with a flight event; the generation does not move."""
    engine = _port_engine(port_gen, "paged")
    trainable, frozen_fp = _split(port_gen)
    pub = CheckpointPublisher(str(tmp_path))
    pub.publish(1, trainable, frozen_fp=frozen_fp, metrics={"eval_loss": 1.0}, run_id="run-a")
    mgr = HotSwapManager(engine, CheckpointWatcher(str(tmp_path),
                                                   base_params=lambda: engine.params))
    assert mgr.poll_once()["step"] == 1
    pub.publish(2, _shift(trainable), frozen_fp=frozen_fp, metrics={"eval_loss": 2.0})
    assert mgr.poll_once() is None
    foreign = {k: np.asarray(v) * 1.01 for k, v in frozen_fp.items()}
    pub.publish(3, _shift(trainable), frozen_fp=foreign, metrics={"eval_loss": 0.5})
    assert mgr.poll_once() is None
    assert engine.weight_generation == 1
    kinds = [e["kind"] for e in engine.recorder.events()]
    assert kinds.count("publish_rejected_eval") == 1
    assert kinds.count("publish_rejected_fingerprint") == 1
    lineage = mgr.lineage()
    assert lineage["generations"]["1"]["run_id"] == "run-a"
    assert [r["kind"] for r in lineage["history"]] == ["deploy"]
    _close(engine)


def test_canary_rejects_failing_replica_before_the_second(port_gen, tmp_path):
    """With a canary judge, replica 0 swaps first; its requests fail (an
    injected prefill fault each), the verdict is a regression, replica 0
    swaps back and replica 1 never swaps; the lineage records the rejection
    with the manifest's run_id."""
    fleet = EngineFleet([_port_engine(port_gen, "paged") for _ in range(2)], routing="prefix")
    trainable, frozen_fp = _split(port_gen)
    CheckpointPublisher(str(tmp_path)).publish(1, _shift(trainable), frozen_fp=frozen_fp,
                                               run_id="run-b")
    canary = CanaryJudge(window_s=1.5, min_requests=2)
    mgr = HotSwapManager(fleet, CheckpointWatcher(
        str(tmp_path), base_params=lambda: fleet.replicas[0].params), canary=canary)
    rep0 = fleet.replicas[0]
    stop = threading.Event()

    def failing_traffic():
        while rep0.weight_generation == 0 and not stop.is_set():
            time.sleep(0.01)
        for i in range(4):
            rep0.faults.fail_prefill_next(1)
            try:
                rep0.submit(_prompt(f"canary {i}"), GREEDY, timeout=TIMEOUT)
            except Exception:  # noqa: BLE001 — failing is the point
                pass

    th = threading.Thread(target=failing_traffic)
    th.start()
    res = mgr.poll_once()
    stop.set()
    th.join(60)
    assert res["kind"] == "canary_rejected", res
    assert res["canary"]["verdict"] == "regression" and res["run_id"] == "run-b"
    assert [e.weight_generation for e in fleet.replicas] == [2, 0]
    assert fleet.replicas[1].stats_snapshot()["weight_swaps"] == 0
    assert mgr.deployed_step == -1
    history = mgr.lineage()["history"]
    assert [r["kind"] for r in history] == ["canary_rejected"] and history[0]["run_id"] == "run-b"
    assert mgr.poll_once() is None  # the rejected step is held
    fleet.close()


def test_adapter_registry_rebinds_to_the_swapped_base(port_gen, tmp_path):
    """With an adapter registry, a swap re-points the pooled view at the
    new base leaves and keeps the pools (the same tensors)."""
    from llm_fine_tune_distributed_tpu_torch.infer.adapters import AdapterRegistry

    os.makedirs(tmp_path / "adapters")
    reg = AdapterRegistry(port_gen.params, str(tmp_path / "adapters"), max_adapters=2)
    pools = {k: v for k, v in reg.params.items() if k.endswith("_pool")}
    engine = _port_engine(port_gen, "paged", adapters=reg)
    trainable, _ = _split(port_gen)
    engine.request_weight_swap(_shift(trainable), fingerprint="fp", step=1, timeout=60)
    for name in trainable:
        assert reg.params[name] is engine.params[name]
        assert torch.equal(reg.params[name], trainable[name] + 0.25)
    assert all(reg.params[k] is v for k, v in pools.items())
    assert list(reg.params) == [k for k in reg.params]  # order kept: kernel, then its pools
    assert engine.submit(_prompt(), GREEDY) == _solo_after(port_gen, engine, _prompt())
    _close(engine)


def test_host_tier_entries_of_another_generation_miss(port_gen):
    """Host-tier entries are stamped with the resident fingerprint: blocks
    spilled before a swap restore before it, miss after it (the prompt
    prefills again, with the new weights' tokens), and blocks spilled after
    it restore again."""
    from llm_fine_tune_distributed_tpu_torch.infer.paged import HostBlockTier

    engine = _port_engine(port_gen, "paged", host_tier=HostBlockTier(64 << 20))
    prompt = _prompt("a forty-ish token victim prompt for host tier spills")
    trainable, _ = _split(port_gen)

    def spill_and_ask():
        """Evict the cached blocks into the tier, ask again: (restore hits,
        restore misses, tokens)."""
        dropped = []
        engine._prefix.evict(engine._num_blocks, collect=dropped)
        engine._spill_to_tier(dropped)
        assert len(dropped) >= 2
        before = engine.stats_snapshot()
        out = engine.submit(prompt, GREEDY, timeout=TIMEOUT)
        snap = engine.stats_snapshot()
        return (snap["host_tier_restore_hits"] - before["host_tier_restore_hits"],
                snap["prefix_tokens_reused"] - before["prefix_tokens_reused"], out)

    first = engine.submit(prompt, GREEDY, timeout=TIMEOUT)
    hits, reused, again = spill_and_ask()
    assert hits >= 2 and reused >= 32 and again == first
    dropped = []
    engine._prefix.evict(engine._num_blocks, collect=dropped)
    engine._spill_to_tier(dropped)  # stamped with the boot fingerprint (None)
    engine.request_weight_swap(_shift(trainable), fingerprint="new", step=1, timeout=60)
    before = engine.stats_snapshot()
    after = engine.submit(prompt, GREEDY, timeout=TIMEOUT)
    snap = engine.stats_snapshot()
    assert snap["host_tier_restore_hits"] == before["host_tier_restore_hits"]
    assert snap["prefix_tokens_reused"] == before["prefix_tokens_reused"]
    assert after == _solo_after(port_gen, engine, prompt) != first
    hits, reused, again = spill_and_ask()  # stamped "new" now: restores
    assert hits >= 2 and reused >= 32 and again == after
    _close(engine)


def test_swap_frees_the_old_leaves_when_the_engine_owned_them(port_gen):
    """A single engine over its own Generator: after a swap the Generator
    holds the new leaves too, so the replaced ones are unreferenced."""
    import weakref

    gen = Generator({k: v.clone() for k, v in port_gen.params.items()}, port_gen.config,
                    ByteChatMLTokenizer(),
                    compute_dtype=torch.float32, eos_token_ids=[], device="cpu")
    engine = _port_engine(gen, "continuous")
    name = _names(gen, 1)[0]
    old = weakref.ref(gen.params[name])
    engine.request_weight_swap({name: gen.params[name] + 0.25}, fingerprint="x", step=1,
                               timeout=60)
    assert gen.params is engine.params
    assert old() is None
    _close(engine)


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_swap_and_rollback_bit_for_bit(cuda, tmp_path):
    """On the card, a paged int8 engine in f32: a swap to shifted weights
    gives the tokens of a fresh engine on those weights, and the rollback
    the pre-swap tokens, bit for bit; the old leaves are freed (memory back
    within 1 MiB)."""
    mc = get_preset("tiny")
    params = _x10(tf.init_params(mc, seed=0, device="cpu", dtype=torch.float32))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gen = Generator(params, mc, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                        eos_token_ids=[], device=cuda)
        engine = _port_engine(gen, "paged", kv_quant="int8")
        prompt = _prompt()
        before = engine.submit(prompt, GREEDY)
        trainable, frozen_fp = _split(gen)
        shifted = {k: v.cpu() + 0.25 for k, v in trainable.items()}
        CheckpointPublisher(str(tmp_path)).publish(1, shifted, frozen_fp=frozen_fp)
        mgr = HotSwapManager(engine, CheckpointWatcher(str(tmp_path),
                                                       base_params=lambda: engine.params))
        torch.cuda.synchronize()
        mem = torch.cuda.memory_allocated()
        assert mgr.poll_once()["step"] == 1
        torch.cuda.synchronize()
        assert abs(torch.cuda.memory_allocated() - mem) <= 1 << 20
        swapped = engine.submit(prompt, GREEDY)
        fresh_params = {k: v.cpu() for k, v in engine.params.items()}
        fresh = _port_engine(Generator(fresh_params, mc, ByteChatMLTokenizer(),
                                       compute_dtype=torch.float32, eos_token_ids=[],
                                       device=cuda), "paged", kv_quant="int8")
        assert swapped == fresh.submit(prompt, GREEDY)
        _close(fresh)
        mgr.rollback()
        assert engine.submit(prompt, GREEDY) == before
        _close(engine)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
