"""Multi-tenant LoRA serving in the port (``infer/adapters.py``, the pooled
delta of ``models/transformer._linear`` and the engines' adapter path)
against the JAX package's, on the ``tiny`` preset in f32, every case of
``tests/test_adapters.py``:

- the registry: the pooled view's shapes, slot 0 bitwise the base forward,
  a resident adapter's forward equal to its merged weights' (rank 2 padded
  into a rank-4 pool included), refcounts, LRU eviction, the pool-full 429
  and the unknown-name 404 with the known list, the rebuild, the rank cap:
  slots, refcounts, evictions, errors and messages equal to the JAX
  registry's step by step;
- the engines (continuous and paged): co-batched tenants beside a base
  request and a sampled neighbour each give exactly their merged-solo
  tokens, speculation included; ``per_tenant``, ``adapter_loads`` and
  ``adapters_resident`` equal the JAX engine's; the no-registry and
  unknown-name 404s and the tenant quota's 429;
- a crash mid multi-tenant decode (``tests/test_supervisor.py``): the
  resident set survives the restart and every tenant's tokens are again
  its merged-solo ones;
- the in-place pool writes under threads: loads and evictions on other
  slots while a tenant decodes leave its tokens and every resident slot's
  rows exact;
- the prefix-key fault: a tenant whose prompt shares full blocks with the
  base model's or another tenant's prompt gets its merged-solo tokens on
  the port's paged engine (its keys are salted with the adapter's name),
  with prefix hits only within a tenant; the JAX paged engine, which keys
  by tokens alone, reuses the base model's K/V and gives other tokens.

Concurrency is scripted with a gate on the decode step, never with sleeps.
"""

import os
import shutil
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu.config import TrainConfig
from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer as JaxTokenizer
from llm_fine_tune_distributed_tpu.infer import GenerationConfig as JaxGenerationConfig
from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator
from llm_fine_tune_distributed_tpu.infer import engine as jax_engine
from llm_fine_tune_distributed_tpu.infer.adapters import AdapterRegistry as JaxRegistry
from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_get_preset
from llm_fine_tune_distributed_tpu.models.transformer import init_params as jax_init_params
from llm_fine_tune_distributed_tpu.parallel import lora as jax_lora
from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer import adapters as adapters_mod
from llm_fine_tune_distributed_tpu_torch.infer.adapters import AdapterRegistry
from llm_fine_tune_distributed_tpu_torch.infer.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from llm_fine_tune_distributed_tpu_torch.infer.errors import (
    AdapterPoolFullError,
    RetryableEngineError,
    TenantQuotaError,
    UnknownAdapterError,
)
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
from llm_fine_tune_distributed_tpu_torch.models.transformer import forward
from llm_fine_tune_distributed_tpu_torch.parallel.lora import load_lora_adapter, merge_lora

CFG = get_preset("tiny")
JCFG = jax_get_preset("tiny")
GEOMETRY = {"continuous": dict(slots=4, buf_len=96, prompt_bucket=16),
            "paged": dict(slots=4, buf_len=96, prompt_bucket=16, block_len=16, prefill_chunk=32)}
KINDS = ("continuous", "paged")
TENANTS = ("t1", "t2", "t3")
TIMEOUT = 240


def _greedy(n=6, **kw):
    return dict(max_new_tokens=n, do_sample=False, **kw)


SAMPLED = dict(max_new_tokens=24, do_sample=True, temperature=1.0)


def _enc(text):
    return list(text.encode("utf-8"))


PROMPTS = [_enc(t) for t in ("alpha", "beta bravo", "the quick brown fox")]


def _bump(tree, seed, std=0.02):
    """Non-zero B (a fresh LoRA init has B = 0: every tenant would be the
    base model)."""
    counter = [seed]

    def walk(node):
        if isinstance(node, dict):
            if "lora_b" in node:
                node = dict(node)
                rs = np.random.RandomState(counter[0])
                counter[0] += 1
                node["lora_b"] = jnp.asarray(rs.normal(0.0, std, node["lora_b"].shape),
                                             jnp.float32)
                return node
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(tree)


def _make_adapter(base, outdir, seed, rank=4, alpha=8.0, std=0.02):
    """A PEFT directory written by the JAX package's ``save_lora_adapter``."""
    params = _bump(jax_lora.add_lora_params(base, jax.random.PRNGKey(seed), rank=rank,
                                            alpha=alpha), seed, std)
    jax_lora.save_lora_adapter(params, outdir, TrainConfig(freeze_strategy="lora",
                                                           lora_rank=rank, lora_alpha=alpha))


class _Gate:
    """Holds the engine's decode step: the worker parks in ``wait`` until
    the test lets one step through (``step``) or opens the gate."""

    def __init__(self):
        self._permits = threading.Semaphore(0)
        self._open = threading.Event()
        self._parked = threading.Event()

    def wait(self):
        if self._open.is_set():
            return
        self._parked.set()
        self._permits.acquire()

    def park(self):
        assert self._parked.wait(TIMEOUT), "the worker never reached the gate"
        self._parked.clear()

    def open(self):
        self._open.set()
        for _ in range(64):
            self._permits.release()


class _PortGated:
    """The port's Generator with its plain decode steps behind a gate."""

    def __init__(self, gen, gate):
        self._gen, self._gate = gen, gate

    def __getattr__(self, name):
        return getattr(self._gen, name)

    def slot_step(self, *a):
        self._gate.wait()
        return self._gen.slot_step(*a)

    def paged_step(self, *a):
        self._gate.wait()
        return self._gen.paged_step(*a)


class _JaxGated:
    """The JAX Generator with its compiled decode steps behind a gate."""

    def __init__(self, gen, gate):
        self._gen, self._gate = gen, gate

    def __getattr__(self, name):
        return getattr(self._gen, name)

    def _gated(self, step):
        def run(*a):
            self._gate.wait()
            return step(*a)
        return run

    def slot_step(self, *a):
        return self._gated(self._gen.slot_step(*a))

    def paged_step(self, *a):
        return self._gated(self._gen.paged_step(*a))


def _wait(cond, timeout=TIMEOUT, poll=0.002):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached in time"
        time.sleep(poll)


@pytest.fixture(scope="module")
def jbase():
    return jax_init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)


@pytest.fixture(scope="module")
def base(jbase):
    return params_from_jax({k: np.asarray(v) for k, v in flatten_tree(jbase).items()}, CFG)


@pytest.fixture(scope="module")
def adapter_dir(jbase, tmp_path_factory):
    """t1/t2 at rank 4, t3 at rank 2 (the pool pads it to rank 4)."""
    root = tmp_path_factory.mktemp("adapters")
    for name, seed, rank in (("t1", 1, 4), ("t2", 2, 4), ("t3", 3, 2)):
        _make_adapter(jbase, str(root / name), seed, rank=rank)
    return str(root)


@pytest.fixture(scope="module")
def sides(jbase, base, adapter_dir):
    """Each package's Generator over the same base weights, its engine
    classes, registry, config type and per-tenant merged-solo generators."""
    jgen = JaxGenerator(jbase, JCFG, JaxTokenizer(), compute_dtype=jnp.float32, eos_token_ids=[])
    gen = Generator(base, CFG, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                    eos_token_ids=[], device="cpu")
    jmerged = {n: JaxGenerator(jax_lora.merge_lora(jax_lora.load_lora_adapter(
        jbase, os.path.join(adapter_dir, n))), JCFG, JaxTokenizer(), compute_dtype=jnp.float32,
        eos_token_ids=[]) for n in TENANTS}
    merged = {n: Generator(merge_lora(load_lora_adapter(base, os.path.join(adapter_dir, n))),
                           CFG, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                           eos_token_ids=[], device="cpu") for n in TENANTS}
    return {
        "jax": dict(gen=jgen, base=jbase, registry=JaxRegistry, config=JaxGenerationConfig,
                    continuous=jax_engine.ContinuousBatchingEngine,
                    paged=jax_engine.PagedContinuousBatchingEngine, gated=_JaxGated,
                    merged=jmerged),
        "port": dict(gen=gen, base=base, registry=AdapterRegistry, config=GenerationConfig,
                     continuous=ContinuousBatchingEngine, paged=PagedContinuousBatchingEngine,
                     gated=_PortGated, merged=merged),
    }


def _registry(side, adapter_dir, **kw):
    return side["registry"](side["base"], adapter_dir, **kw)


def _engine(side, kind, reg, gate=None, **kw):
    gen = side["gen"] if gate is None else side["gated"](side["gen"], gate)
    return side[kind](gen, adapters=reg, **{**GEOMETRY[kind], **kw})


def _close(eng, gate=None):
    if gate is not None:
        gate.open()
    if hasattr(eng, "close"):  # the JAX engines' workers are daemons without close()
        eng.close()


def _ids(b=2, s=16):
    return np.random.RandomState(1).randint(0, CFG.vocab_size, (b, s)).astype(np.int64)


# ------------------------------------------------------------------ registry


def test_pool_view_shapes_and_identity_slot(base, adapter_dir):
    reg = AdapterRegistry(base, adapter_dir, max_adapters=4)
    q = "model.layers.0.self_attn.q_proj."
    assert reg.params[q + "lora_a_pool"].shape == (4, CFG.hidden_size, reg.rank)
    assert reg.params[q + "lora_b_pool"].shape[:2] == (4, reg.rank)
    assert reg.params[q + "lora_scale_pool"].shape == (4,)
    assert reg.params[q + "lora_a_pool"].dtype == torch.float32
    assert reg.rank == 4  # the largest r on disk
    assert all(reg.params[k] is v for k, v in base.items())  # the base is shared, not copied
    assert reg.pool_bytes() == sum(t.nbytes for k, t in reg.params.items() if "_pool" in k)
    ids = torch.from_numpy(_ids())
    ref, _ = forward(base, ids, CFG, compute_dtype=torch.float32)
    out, _ = forward(reg.params, ids, CFG, compute_dtype=torch.float32,
                     adapter_idx=torch.zeros(2, dtype=torch.long))
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


def test_resident_adapter_matches_merged_forward(sides, base, adapter_dir):
    """A loaded slot's pooled forward equals the merged weights' forward,
    the rank-2 adapter padded into the rank-4 pool included."""
    reg = AdapterRegistry(base, adapter_dir, max_adapters=4)
    ids = torch.from_numpy(_ids())
    plain, _ = forward(base, ids, CFG, compute_dtype=torch.float32)
    for name in ("t1", "t3"):
        slot = reg.acquire(name)
        ref, _ = forward(sides["port"]["merged"][name].params, ids, CFG,
                         compute_dtype=torch.float32)
        out, _ = forward(reg.params, ids, CFG, compute_dtype=torch.float32,
                         adapter_idx=torch.full((2,), slot, dtype=torch.long))
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5, rtol=0)
        assert (out - plain).abs().max() > 1e-4  # the delta is real
        reg.release(name)


def _registry_script(reg):
    """The JAX file's refcount and LRU script: a record of slots, counts,
    residency and refusals (status, kind, message)."""
    rec = []

    def step(label, fn):
        try:
            rec.append((label, "ok", fn()))
        except Exception as e:  # noqa: BLE001 - either package's error, by duck type
            rec.append((label, "err", getattr(e, "status", None), type(e).__name__, str(e),
                        sorted(getattr(e, "known", ()))))

    step("acquire t1", lambda: reg.acquire("t1"))
    step("counts", lambda: (reg.slot_of("t1"), reg.refcount("t1")))
    step("acquire t1 again", lambda: reg.acquire("t1"))
    step("acquire t2", lambda: reg.acquire("t2"))
    step("acquire t3 (full)", lambda: reg.acquire("t3"))
    step("release t2", lambda: reg.release("t2"))
    step("t2 warm", lambda: (reg.is_resident("t2"), reg.refcount("t2")))
    step("acquire t2 warm", lambda: reg.acquire("t2"))
    step("release t2 again", lambda: reg.release("t2"))
    step("acquire t3 (evicts t2)", lambda: reg.acquire("t3"))
    step("after", lambda: (reg.is_resident("t2"), reg.is_resident("t1"), reg.refcount("t1"),
                           sorted(reg.resident())))
    step("unknown", lambda: reg.acquire("nope"))
    step("traversal", lambda: reg.acquire(f"..{os.sep}t1"))
    step("release unknown", lambda: reg.release("nope"))
    return rec


def test_registry_lifecycle_equals_jax(sides, adapter_dir):
    """Slots, refcounts, the LRU eviction of the idle adapter (never the
    pinned one), the pool-full 429 and the unknown-name 404 with the known
    list: the same record as the JAX registry's, message for message."""
    got = _registry_script(_registry(sides["port"], adapter_dir, max_adapters=3))
    want = _registry_script(_registry(sides["jax"], adapter_dir, max_adapters=3))
    assert got == want
    statuses = {r[0]: r[2] for r in got if r[1] == "err"}
    assert statuses == {"acquire t3 (full)": 429, "unknown": 404, "traversal": 404}
    assert dict((r[0], r[2]) for r in got if r[1] == "ok")["after"] == (
        False, True, 2, ["t1", "t3"])
    unknown = next(r for r in got if r[0] == "unknown")
    assert unknown[5] == list(TENANTS)
    err = UnknownAdapterError("x", known=("t1",))
    assert err.to_dict()["known_adapters"] == ["t1"]


def test_rebuild_restores_resident_slots(base, adapter_dir):
    """The restart path: pools clobbered, ``rebuild()`` writes every
    resident adapter back from its host copy, at its slot."""
    reg = AdapterRegistry(base, adapter_dir, max_adapters=4)
    slot = reg.acquire("t1")
    pool = reg.params["model.layers.0.self_attn.q_proj.lora_a_pool"]
    before = pool.clone()
    assert before[slot].abs().max() > 0
    for name, t in reg.params.items():
        if name.endswith("_pool"):
            t.zero_()
    reg.rebuild()
    torch.testing.assert_close(pool, before, rtol=0, atol=0)
    assert reg.slot_of("t1") == slot


def test_rank_refusals_equal_jax(sides, adapter_dir, tmp_path):
    """An adapter above the pool rank, and a pool of one slot. The pool's
    rank is scanned at build, so a rank-4 adapter written under the
    directory after a registry was built over rank-2 ones is refused."""
    msgs = []
    for side in ("jax", "port"):
        root = tmp_path / side
        shutil.copytree(os.path.join(adapter_dir, "t3"), root / "t3")  # rank 2
        reg = _registry(sides[side], str(root), max_adapters=4)
        shutil.copytree(os.path.join(adapter_dir, "t1"), root / "t1")  # rank 4
        with pytest.raises(ValueError, match="pool rank") as e:
            reg.acquire("t1")  # rank 4 > pool rank 2
        with pytest.raises(ValueError) as e2:
            _registry(sides[side], adapter_dir, max_adapters=1)
        msgs.append((str(e.value), str(e2.value)))
    assert msgs[0] == msgs[1]


class _HeldLoad:
    """Holds the registry's adapter load (its file read) until released:
    ``entered`` is set once a load is inside it."""

    def __init__(self, monkeypatch):
        self.entered, self.go = threading.Event(), threading.Event()
        plain = adapters_mod.peft_adapter_state

        def held(*a, **kw):
            self.entered.set()
            assert self.go.wait(TIMEOUT), "the held load was never released"
            return plain(*a, **kw)

        monkeypatch.setattr(adapters_mod, "peft_adapter_state", held)


def test_hot_load_runs_outside_the_lock(base, adapter_dir, monkeypatch):
    """While t2's load is held mid-read on its reserved slot: t1 is pinned
    and released and the probes answer (none waits for the load), t2 is not
    resident yet and its slot is not handed to t3's load, and a second
    acquire of t2 waits for the load and shares its slot. A load that fails
    frees its reserved slot."""
    reg = AdapterRegistry(base, adapter_dir, max_adapters=3)
    s1 = reg.acquire("t1")
    held = _HeldLoad(monkeypatch)
    out = {}
    first = threading.Thread(target=lambda: out.setdefault("first", reg.acquire("t2")))
    first.start()
    assert held.entered.wait(TIMEOUT)
    reg.release("t1")
    assert reg.acquire("t1") == s1 and reg.refcount("t1") == 1
    assert reg.resident() == ["t1"] and not reg.is_resident("t2") and reg.slot_of("t2") is None
    with pytest.raises(AdapterPoolFullError):
        reg.acquire("t3")  # slot 1 pinned by t1, slot 2 reserved by t2's load
    second = threading.Thread(target=lambda: out.setdefault("second", reg.acquire("t2")))
    second.start()
    held.go.set()
    for th in (first, second):
        th.join(TIMEOUT)
        assert not th.is_alive()
    assert out["first"] == out["second"] == reg.slot_of("t2") != s1
    assert reg.refcount("t2") == 2 and reg.stats is None
    reg.release("t1")
    monkeypatch.setattr(adapters_mod, "peft_adapter_state",
                        lambda *a, **kw: (_ for _ in ()).throw(ValueError("bad adapter")))
    with pytest.raises(ValueError, match="bad adapter"):
        reg.acquire("t3")  # evicts idle t1 for its slot, then fails
    assert reg.resident() == ["t2"] and reg._loading == {}
    monkeypatch.undo()
    assert reg.acquire("t3") == s1  # the failed load's slot is free


def test_tenant_quota_counts_a_request_still_loading(sides, adapter_dir, monkeypatch):
    """--adapter-capacity 1: t1's first request holds its quota from the
    check on, while its adapter is still loading, so a second t1 request
    arriving meanwhile is shed (429); a request whose acquire fails (an
    unknown adapter) leaves no count behind."""
    reg = AdapterRegistry(sides["port"]["base"], adapter_dir, max_adapters=4)
    eng = _engine(sides["port"], "continuous", reg, adapter_quota=1)
    held = _HeldLoad(monkeypatch)
    try:
        out = {}
        first = threading.Thread(target=lambda: out.setdefault("t1", list(eng.submit(
            PROMPTS[0], GenerationConfig(**_greedy()), timeout=TIMEOUT, adapter="t1"))))
        first.start()
        assert held.entered.wait(TIMEOUT)
        with pytest.raises(TenantQuotaError):
            eng.submit(PROMPTS[1], GenerationConfig(**_greedy()), timeout=30, adapter="t1")
        with pytest.raises(UnknownAdapterError):
            eng.submit(PROMPTS[1], GenerationConfig(**_greedy()), timeout=30, adapter="ghost")
        held.go.set()
        first.join(TIMEOUT)
        assert not first.is_alive() and len(out["t1"]) == 6
        assert eng._tenant_inflight == {}
        assert eng.stats_snapshot()["requests_shed_tenant_quota"] == 1
    finally:
        _close(eng)


def test_in_place_pool_writes_under_threads(sides, base, adapter_dir):
    """A tenant decodes (its slot pinned) while more threads than cores,
    with a short switch interval, load, release and evict the other slot
    over and over: the slot being loaded is only its own request's and the
    evicted one is idle, so the decoding tenant's tokens are its
    merged-solo ones, every resident slot's rows equal its host copy, and
    no pin is lost (every refcount back to 0, each slot one adapter's)."""
    gate = _Gate()
    reg = AdapterRegistry(base, adapter_dir, max_adapters=3)
    eng = _engine(sides["port"], "continuous", reg, gate)
    interval = sys.getswitchinterval()
    try:
        gen = GenerationConfig(**_greedy(12))
        want = sides["port"]["merged"]["t1"].generate_ids(PROMPTS[0], gen)
        out = {}
        t = threading.Thread(target=lambda: out.setdefault("t1", eng.submit(
            PROMPTS[0], gen, timeout=TIMEOUT, adapter="t1")))
        t.start()
        gate.park()  # t1 admitted and prefilled, its first decode step held
        errors = []

        def churn(name):
            try:
                for _ in range(3):
                    while True:
                        try:
                            reg.acquire(name)
                            break
                        except AdapterPoolFullError:
                            time.sleep(0)  # another churner holds the free slot
                    reg.release(name)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        sys.setswitchinterval(1e-6)
        churners = [threading.Thread(target=churn, args=(("t2", "t3")[i % 2],))
                    for i in range((os.cpu_count() or 1) + 1)]
        for c in churners:
            c.start()
        gate.open()  # decode runs while the churners load and evict slot 2
        for c in churners + [t]:
            c.join(TIMEOUT)
            assert not c.is_alive()
        sys.setswitchinterval(interval)
        assert not errors, errors
        assert out["t1"] == want
        assert reg.slot_of("t1") == 1 and all(reg.refcount(n) == 0 for n in TENANTS)
        resident = reg.resident()
        assert len(resident) == len(set(resident)) == 2
        module = "model.layers.1.mlp.down_proj"
        for name in resident:
            slot, (padded, scale) = reg.slot_of(name), reg._host[name]
            torch.testing.assert_close(reg.params[module + ".lora_a_pool"][slot],
                                       padded[module][0], rtol=0, atol=0)
            torch.testing.assert_close(reg.params[module + ".lora_b_pool"][slot],
                                       padded[module][1], rtol=0, atol=0)
            assert float(reg.params[module + ".lora_scale_pool"][slot]) == scale
        snap = eng.stats_snapshot()
        assert snap["adapter_loads"] >= 2 and snap["adapter_loads"] == snap["adapter_evictions"] + 2
    finally:
        sys.setswitchinterval(interval)
        _close(eng, gate)


# ------------------------------------------------------- engine integration


def _cobatched(side, kind, adapter_dir):
    """The JAX file's co-batching script, gated: a sampled base neighbour
    decodes, then t1, t2 and a base request join the same batch. Returns
    the greedy tokens, the registry's state and the snapshot's tenant keys."""
    gate = _Gate()
    reg = _registry(side, adapter_dir, max_adapters=4)
    eng = _engine(side, kind, reg, gate)
    cfg = side["config"]
    try:
        results, threads = {}, []

        def ask(key, prompt, gen, **kw):
            def run():
                results[key] = list(eng.submit(prompt, gen, timeout=TIMEOUT, **kw))
            th = threading.Thread(target=run)
            th.start()
            threads.append(th)

        ask("neighbour", PROMPTS[0], cfg(**SAMPLED), seed=11)
        gate.park()  # the neighbour decodes; the rest arrive into its batch
        depth = eng.queue_depth
        ask("t1", PROMPTS[0], cfg(**_greedy()), adapter="t1")
        ask("t2", PROMPTS[1], cfg(**_greedy()), adapter="t2")
        ask("base", PROMPTS[2], cfg(**_greedy()))
        _wait(lambda: eng.queue_depth >= depth + 3 or len(results) > 1)
        gate.open()
        for th in threads:
            th.join(TIMEOUT)
            assert not th.is_alive()
        snap = eng.stats_snapshot()
        return ({k: v for k, v in results.items() if k != "neighbour"},
                (reg.refcount("t1"), reg.refcount("t2"), sorted(reg.resident())),
                {k: snap[k] for k in ("per_tenant", "adapters_resident", "adapter_loads",
                                      "adapter_evictions", "requests_shed_tenant_quota")})
    finally:
        _close(eng, gate)


@pytest.mark.parametrize("kind", KINDS)
def test_cobatched_tenants_equal_merged_solo(sides, adapter_dir, kind):
    """The tentpole's guarantee: t1, t2 and a base request co-batched in one
    decode batch beside a live sampled neighbour each give exactly the
    tokens of their adapter merged into the weights and served solo; pins
    released, both adapters warm, and the tenant records equal the JAX
    engine's."""
    port = sides["port"]
    results, registry, snap = _cobatched(port, kind, adapter_dir)
    gen = GenerationConfig(**_greedy())
    want = {"t1": port["merged"]["t1"].generate_ids(PROMPTS[0], gen),
            "t2": port["merged"]["t2"].generate_ids(PROMPTS[1], gen),
            "base": port["gen"].generate_ids(PROMPTS[2], gen)}
    assert results == want
    assert results["t1"] != port["gen"].generate_ids(PROMPTS[0], gen)  # really adapted
    assert registry == (0, 0, ["t1", "t2"])
    for name in ("t1", "t2"):
        assert snap["per_tenant"][name] == {"requests": 1, "tokens": 6, "queue_depth": 0}
    assert snap["adapters_resident"] == 2 and snap["adapter_loads"] == 2
    jresults, jregistry, jsnap = _cobatched(sides["jax"], kind, adapter_dir)
    assert (jresults, jregistry, jsnap) == (results, registry, snap)


@pytest.mark.parametrize("kind", KINDS)
def test_speculative_cobatch_equals_merged_solo(sides, adapter_dir, kind):
    """Adapters through the fused draft-verify tick: each tenant's greedy
    speculative tokens equal its plain merged-solo decode."""
    port = sides["port"]
    reg = AdapterRegistry(port["base"], adapter_dir, max_adapters=4)
    eng = _engine(port, kind, reg, speculative_k=4)
    prompts = [_enc("water water water water water"), _enc("abc abc abc abc abc")]
    try:
        results = {}

        def ask(key, prompt, adapter):
            results[key] = eng.submit(prompt, GenerationConfig(**_greedy(12, speculative_lookup=4)),
                                      timeout=TIMEOUT, adapter=adapter)

        threads = [threading.Thread(target=ask, args=("t1", prompts[0], "t1")),
                   threading.Thread(target=ask, args=("t2", prompts[1], "t2"))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
        plain = GenerationConfig(**_greedy(12))
        assert results == {"t1": port["merged"]["t1"].generate_ids(prompts[0], plain),
                           "t2": port["merged"]["t2"].generate_ids(prompts[1], plain)}
        assert eng.stats_snapshot()["draft_tokens_proposed"] > 0  # it did speculate
    finally:
        _close(eng)


def test_engine_without_registry_rejects_adapter(sides):
    msgs = []
    for side in ("jax", "port"):
        eng = sides[side]["continuous"](sides[side]["gen"], **GEOMETRY["continuous"])
        with pytest.raises(Exception) as e:
            eng.submit(PROMPTS[0], sides[side]["config"](**_greedy()), timeout=30, adapter="t1")
        msgs.append((type(e.value).__name__, e.value.status, str(e.value)))
        _close(eng)
    assert msgs[0] == msgs[1] and "--adapter-dir" in msgs[1][2] and msgs[1][1] == 404


def test_unknown_adapter_through_engine(sides, adapter_dir):
    reg = AdapterRegistry(sides["port"]["base"], adapter_dir, max_adapters=4)
    eng = _engine(sides["port"], "continuous", reg)
    try:
        with pytest.raises(UnknownAdapterError) as ei:
            eng.submit(PROMPTS[0], GenerationConfig(**_greedy()), timeout=30, adapter="ghost")
        assert ei.value.status == 404 and "t1" in ei.value.known
        assert eng.stats_snapshot()["requests_admitted"] == 0
    finally:
        _close(eng)


def _quota_script(side, adapter_dir):
    """--adapter-capacity 1, gated: t1's second request in flight is shed
    with a tenant 429 while t2 is admitted; the slot frees at settle."""
    gate = _Gate()
    reg = _registry(side, adapter_dir, max_adapters=4)
    eng = _engine(side, "continuous", reg, gate, adapter_quota=1)
    cfg = side["config"]
    try:
        out, threads = {}, []

        def ask(key, prompt, gen, adapter):
            th = threading.Thread(target=lambda: out.setdefault(key, list(eng.submit(
                prompt, gen, timeout=TIMEOUT, adapter=adapter))))
            th.start()
            threads.append(th)

        ask("t1 long", PROMPTS[0], cfg(**_greedy(64)), "t1")
        gate.park()  # t1 in flight
        with pytest.raises(Exception) as e:
            eng.submit(PROMPTS[1], cfg(**_greedy()), timeout=30, adapter="t1")
        shed = (type(e.value).__name__, e.value.status, e.value.retryable,
                e.value.retry_after_s is not None, str(e.value))
        ask("t2", PROMPTS[1], cfg(**_greedy()), "t2")  # another tenant is unaffected
        gate.open()
        for th in threads:
            th.join(TIMEOUT)
            assert not th.is_alive()
        again = list(eng.submit(PROMPTS[0], cfg(**_greedy()), timeout=TIMEOUT, adapter="t1"))
        snap = eng.stats_snapshot()
        return (shed, sorted(out), again, snap["requests_shed_tenant_quota"], snap["per_tenant"])
    finally:
        _close(eng, gate)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_bytes_read_adapter_pools_only_when_gathered(sides, adapter_dir, kind):
    """The HBM gauge's byte model: every decode tick reads the base weights
    (not the idle pools), and a tick whose live rows gather an adapter adds
    one pool slot's bytes; the memory report still counts the whole pooled
    view, as the JAX engine's does."""
    port = sides["port"]
    reg = AdapterRegistry(port["base"], adapter_dir, max_adapters=4)
    eng = _engine(port, kind, reg)
    try:
        eng.submit(PROMPTS[0], GenerationConfig(**_greedy()), timeout=TIMEOUT)
        base_ticks, _, _, base_only = eng.decode_cost()
        assert eng._decode_work.sums[5] == 0
        eng.submit(PROMPTS[0], GenerationConfig(**_greedy()), timeout=TIMEOUT, adapter="t1")
        ticks, _, _, both = eng.decode_cost()
        sums = eng._decode_work.sums
        report = eng.memory_breakdown()["weight_bytes"]
    finally:
        eng.close()
    base_bytes = sum(t.nbytes for t in port["base"].values())
    slot_bytes = reg.pool_bytes() // 4
    assert report == base_bytes + reg.pool_bytes()
    assert base_ticks == 5 and ticks == 10 and sums[5] == 5
    # the same prompt and length: the tenant's ticks differ from the base
    # ones by exactly the gathered slot
    assert both - 2 * base_only == 5 * slot_bytes
    assert base_only > 5 * base_bytes


def test_tenant_quota_sheds_with_429(sides, adapter_dir):
    got = _quota_script(sides["port"], adapter_dir)
    assert got[0][:4] == (TenantQuotaError.__name__, 429, True, True)
    assert got[1] == ["t1 long", "t2"] and got[3] == 1
    assert got[4]["t1"]["requests"] == 2  # the shed one is never counted
    assert got == _quota_script(sides["jax"], adapter_dir)


@pytest.mark.parametrize("kind", KINDS)
def test_multitenant_crash_restores_residents(sides, adapter_dir, kind):
    """A decode failure mid multi-tenant decode (``test_supervisor.py``):
    the requests in flight fail retryably and release their pins, the
    restart rebuilds the resident set, and each tenant's tokens are again
    exactly its merged-solo ones."""
    port = sides["port"]
    reg = AdapterRegistry(port["base"], adapter_dir, max_adapters=4)
    eng = _engine(port, kind, reg, restart_backoff_s=0.01, restart_backoff_max_s=0.02)
    gen = GenerationConfig(**_greedy())
    solo = {"t1": port["merged"]["t1"].generate_ids(PROMPTS[0], gen),
            "t2": port["merged"]["t2"].generate_ids(PROMPTS[1], gen)}
    try:
        assert eng.submit(PROMPTS[0], gen, timeout=TIMEOUT, adapter="t1") == solo["t1"]
        assert eng.submit(PROMPTS[1], gen, timeout=TIMEOUT, adapter="t2") == solo["t2"]
        assert sorted(reg.resident()) == ["t1", "t2"]
        eng.faults.fail_decode_next(1)
        outcomes = [None, None]

        def ask(i, name):
            try:
                outcomes[i] = ("ok", eng.submit(PROMPTS[i], gen, timeout=60, adapter=name))
            except BaseException as e:  # noqa: BLE001 - recording the outcome
                outcomes[i] = ("err", e)

        threads = [threading.Thread(target=ask, args=(0, "t1")),
                   threading.Thread(target=ask, args=(1, "t2"))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive(), "a waiter hung"
        errs = [o[1] for o in outcomes if o[0] == "err"]
        assert errs and all(isinstance(e, RetryableEngineError) for e in errs), outcomes
        assert reg.refcount("t1") == 0 and reg.refcount("t2") == 0
        assert sorted(reg.resident()) == ["t1", "t2"]
        assert eng.submit(PROMPTS[0], gen, timeout=TIMEOUT, adapter="t1") == solo["t1"]
        assert eng.submit(PROMPTS[1], gen, timeout=TIMEOUT, adapter="t2") == solo["t2"]
        snap = eng.stats_snapshot()
        assert snap["engine_restarts"] >= 1 and snap["adapters_resident"] == 2
        assert snap["per_tenant"]["t1"]["queue_depth"] == 0 and eng.healthy
    finally:
        _close(eng)


# ---------------------------------------------------------- the prefix keys


def _shared_prompts():
    """Four prompts over one 40-token prefix: two full 16-token blocks in
    common, then each its own tail."""
    prefix = _enc("You are a careful wilderness guide; answer in short. Q: ")[:40]
    return [prefix + _enc(tail) for tail in ("water?", "knots?", "fire??", "shelter")]


@pytest.fixture(scope="module")
def strong_adapters(jbase, tmp_path_factory):
    """Two tenants whose deltas visibly move K and V (B at std 0.2)."""
    root = tmp_path_factory.mktemp("strong_adapters")
    for name, seed in (("t1", 21), ("t2", 22)):
        _make_adapter(jbase, str(root / name), seed, std=0.2)
    return str(root)


def _strong_merged(side, base, root, name):
    if side == "jax":
        return JaxGenerator(jax_lora.merge_lora(jax_lora.load_lora_adapter(
            base, os.path.join(root, name))), JCFG, JaxTokenizer(),
            compute_dtype=jnp.float32, eos_token_ids=[])
    return Generator(merge_lora(load_lora_adapter(base, os.path.join(root, name))), CFG,
                     ByteChatMLTokenizer(), compute_dtype=torch.float32, eos_token_ids=[],
                     device="cpu")


def _shared_prefix_run(side, root):
    """Base, t1, t2, then t1 again, one after another on one paged engine:
    (tokens by request, prompt tokens each one reused from the prefix
    cache, the port's ``prefix_hits`` at the end or None)."""
    reg = _registry(side, root, max_adapters=4)
    eng = _engine(side, "paged", reg)
    cfg = side["config"](**_greedy(8))
    prompts = _shared_prompts()
    try:
        out, reused, before = [], [], 0
        for prompt, adapter in zip(prompts, (None, "t1", "t2", "t1")):
            out.append(list(eng.submit(prompt, cfg, timeout=TIMEOUT, adapter=adapter)))
            now = eng.stats_snapshot()["prefix_tokens_reused"]
            reused.append(now - before)
            before = now
        return out, reused, eng.stats_snapshot().get("prefix_hits")
    finally:
        _close(eng)


def test_tenant_never_reuses_another_tenants_blocks(sides, strong_adapters):
    """On the port's paged engine the tenants' keys are salted: t1 and t2
    miss the base model's two cached blocks (and each other's), the second
    t1 request hits t1's own, and every request's tokens equal its
    merged-solo run."""
    port = sides["port"]
    out, reused, hits = _shared_prefix_run(port, strong_adapters)
    prompts, gen = _shared_prompts(), GenerationConfig(**_greedy(8))
    want = [port["gen"].generate_ids(prompts[0], gen)] + [
        _strong_merged("port", port["base"], strong_adapters, name).generate_ids(p, gen)
        for p, name in zip(prompts[1:], ("t1", "t2", "t1"))]
    assert out == want
    assert reused == [0, 0, 0, 32] and hits == 1


def test_jax_engine_reuses_the_base_models_blocks_for_a_tenant(sides, strong_adapters):
    """The fault the port's salted keys guard against, shown on the JAX
    paged engine: its keys are the tokens alone, so t1 maps the two blocks
    the base request cached (K/V from the base ``k_proj``/``v_proj``) and
    its tokens leave its merged-solo run."""
    jax_side = sides["jax"]
    out, reused, _ = _shared_prefix_run(jax_side, strong_adapters)
    assert reused[1] == 32  # t1 mapped the base model's two blocks
    prompts = _shared_prompts()
    solo = _strong_merged("jax", jax_side["base"], strong_adapters, "t1").generate_ids(
        prompts[1], JaxGenerationConfig(**_greedy(8)))
    assert out[1] != list(solo)
