"""Tensor-parallel slot engines on the CPU (mirrors
``tests/test_sharded_engine.py``): the continuous and paged engines on a
tp=2 Generator, rank 0 announcing every dispatch over the ``SlotBridge`` and
rank 1 mirroring it in ``follow_slots``, each rank a gloo process.

Pinned: the cache and int8 pool leaves hold the rank's kv heads (the JAX
addressable shard's shape); greedy tokens equal the port's one-process
engine and the JAX TP engine's, plain, speculative, paged int8 and across a
preemption; the fallback warning; ``--tp 2`` served by ``python -m
...infer.server`` (rank 0 answers ``/v1/generate`` and ``/v1/stream`` with the
JAX TP engine's tokens, and its shutdown ends the follower with exit code
0); and a follower that fails exits non-zero while rank 0's ``/healthz``
answers 503. Each scenario is one launch of two processes running this file
as a script (torch and the port only); the JAX side runs here.
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer.adapters import AdapterRegistry
from llm_fine_tune_distributed_tpu_torch.infer.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator, make_tp_mesh
from llm_fine_tune_distributed_tpu_torch.infer.multihost import SlotBridge, follow_slots
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.models.carry import params_from_jax
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
from llm_fine_tune_distributed_tpu_torch.parallel.lora import load_lora_adapter, merge_lora
from llm_fine_tune_distributed_tpu_torch.runtime import distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 240
TOK = ByteChatMLTokenizer()
CFG = get_preset("tiny")
TEXTS = ("alpha", "beta bravo", "the quick brown fox")
CASES = {"dense": (False, {}), "paged": (True, {}), "dense-spec": (False, {"speculative_k": 2}),
         "paged-spec": (True, {"speculative_k": 2}), "paged-int8": (True, {"kv_quant": "int8"})}
QUESTION = {"question": "How many cups in a gallon?", "system_prompt": "Be brief.",
            "greedy": True, "max_new_tokens": 8}
SERVE_GEOMETRY = ["--slots", "4", "--kv-buf-len", "256", "--kv-block-len", "16",
                  "--prefill-chunk", "32"]


def _env(rank, world, port):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(distributed.rendezvous_env(rank, world, port), PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return env


def _launch(scenario: str, outdir, world: int = 2, codes=None):
    """Run ``scenario`` of this file in ``world`` gloo processes; each rank
    must exit with its code in ``codes`` (0 by default)."""
    port = distributed.free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), scenario, str(outdir)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=_env(rank, world, port)) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LAUNCH_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        want = (codes or {}).get(rank, 0)
        ok = p.returncode == want if want == 0 else p.returncode != 0
        assert ok, f"rank {rank} exited {p.returncode}:\n{out[-3000:]}\n{err[-6000:]}"
    return outs


def _engine(gen, paged, **kw):
    if paged:
        return PagedContinuousBatchingEngine(gen, slots=4, buf_len=128, prompt_bucket=16,
                                             block_len=16, prefill_chunk=32, **kw)
    return ContinuousBatchingEngine(gen, slots=4, buf_len=128, prompt_bucket=16, **kw)


def _case_cfg(kw):
    spec = 2 if kw.get("speculative_k") else 0
    return dict(max_new_tokens=12, do_sample=False, speculative_lookup=spec)


def _serve_all(eng, cfg):
    """The three prompts served twice (the second pass takes the paged
    engine's prefix hits)."""
    return [eng.submit_full(TOK.encode(t), cfg, seed=0, timeout=240).result
            for _ in range(2) for t in TEXTS]


GEN_KW = dict(compute_dtype=torch.float32, eos_token_ids=[], device="cpu")


def _params():
    return params_from_jax(dict(np.load(os.path.join(sys.argv[2], "params.npz"))), CFG)


def _generators():
    distributed.initialize_distributed(device="cpu")
    params = _params()
    return (Generator(params, CFG, TOK, mesh=make_tp_mesh(2, CFG), **GEN_KW),
            Generator(params, CFG, TOK, **GEN_KW))


def _registry(gen, outdir):
    return AdapterRegistry(gen.params, os.path.join(outdir, "adapters"), max_adapters=4,
                           mesh=gen.mesh, model_config=CFG)


def _write(outdir, name, record):
    with open(os.path.join(outdir, name), "w") as f:
        json.dump(record, f)


# ------------------------------------------------------------ rank processes


def _preempt(gen, solo, bridge) -> dict:
    """The JAX test's preemption dance on a 2-slot paged engine: a greedy
    best_effort victim decoding beside a sampled occupier is preempted by
    an interactive arrival, resumes, and its tokens are the solo run's."""
    eng = PagedContinuousBatchingEngine(gen, slots=2, buf_len=256, prompt_bucket=64,
                                        block_len=16, prefill_chunk=64, bridge=bridge)
    prompt = TOK.encode("preempt me please")
    victim = GenerationConfig(max_new_tokens=48, do_sample=False)
    sampled = GenerationConfig(max_new_tokens=64, do_sample=True, temperature=1.0)
    eng.submit(prompt, victim, priority="best_effort", timeout=240)
    eng.submit(TOK.encode("interactive warm"), sampled, seed=3, timeout=240)
    occupier = threading.Thread(target=lambda: eng.submit(
        TOK.encode("long sampled occupier"), sampled, seed=9, timeout=240))
    occupier.start()
    t0 = time.monotonic()
    while eng.live_slots < 1 and time.monotonic() - t0 < 240:
        time.sleep(0.005)
    stream = eng.stream(prompt, victim, priority="best_effort", timeout=240)
    tokens = [next(stream), next(stream)]
    trigger = threading.Thread(target=lambda: eng.submit(
        TOK.encode("interactive arrival"),
        GenerationConfig(max_new_tokens=8, do_sample=True, temperature=1.0), seed=4, timeout=240))
    trigger.start()
    tokens.extend(stream)
    trigger.join()
    occupier.join()
    preemptions = eng.stats_snapshot()["preemptions"]
    eng.close()
    return {"tokens": tokens, "solo": solo.generate_ids(prompt, victim), "preemptions": preemptions}


def _adapter_rows(gen, solo, bridge, outdir) -> dict:
    """Tenant "t1" on the tp=2 paged engine (each rank's pools its slices,
    the load announced over the bridge) against the adapter merged into
    the weights, served solo; a base request beside it against solo."""
    reg = _registry(gen, outdir)
    eng = _engine(gen, True, bridge=bridge, adapters=reg)
    greedy = GenerationConfig(max_new_tokens=12, do_sample=False)
    merged = Generator(merge_lora(load_lora_adapter(_params(), os.path.join(
        outdir, "adapters", "t1"))), CFG, TOK, **GEN_KW)
    out = {"tp": [eng.submit_full(TOK.encode(t), greedy, timeout=240, adapter="t1").result
                  for t in TEXTS],
           "merged": [merged.generate_ids(TOK.encode(t), greedy) for t in TEXTS],
           "base_tp": eng.submit_full(TOK.encode(TEXTS[0]), greedy, timeout=240).result,
           "base_solo": solo.generate_ids(TOK.encode(TEXTS[0]), greedy)}
    eng.close()
    return out


def _hot_swap(gen, bridge) -> dict:
    """The JAX test's hot-swap on the tp=2 continuous engine: the embedding
    x1.25 goes to every rank (rank 0 broadcasts the whole leaf, each rank
    slices its vocab rows); the tokens after it against an engine on the
    swapped weights served solo; the resident leaves gathered whole."""
    eng = _engine(gen, False, bridge=bridge)
    greedy = GenerationConfig(max_new_tokens=12, do_sample=False)
    _serve_all(eng, greedy)
    params = _params()
    new_embed = params["model.embed_tokens.weight"] * 1.25
    result = eng.request_weight_swap({"model.embed_tokens.weight": new_embed}, fingerprint="x",
                                     timeout=240)
    got = _serve_all(eng, greedy)
    names = ["model.embed_tokens.weight", "model.layers.0.self_attn.k_proj.kernel",
             "model.layers.0.mlp.down_proj.kernel", "model.norm.weight"]
    whole = eng.resident_params(names)
    eng.close()
    swapped = dict(params, **{"model.embed_tokens.weight": new_embed})
    ref = _engine(Generator(swapped, CFG, TOK, **GEN_KW), False)
    want = _serve_all(ref, greedy)
    ref.close()
    return {"tp": got, "solo": want, "updated": result["updated_leaves"],
            "gathered_equal": all(torch.equal(whole[n], swapped[n]) for n in names)}


def _engines_main(outdir) -> None:
    """Rank 0 serves every case through the bridge, then the preemption;
    rank 1 follows. Both record their cache and pool leaves' shapes."""
    gen, solo = _generators()
    rank = distributed.process_index()
    cache, _ = gen.init_slot_state(4, 128)
    pool, _ = gen.init_paged_state(4, 32, 16, "int8")
    record = {"dense_k": list(cache["layers"]["0"]["k"].shape),
              "pool_k": list(pool["layers"]["0"]["k"].shape),
              "pool_k_scale": list(pool["layers"]["0"]["k_scale"].shape)}
    del cache, pool
    if rank:
        follow_slots(gen, adapters=_registry(gen, outdir))
        _write(outdir, "engines_rank1.json", record)
        return
    bridge = SlotBridge(gen)
    for name, (paged, kw) in CASES.items():
        cfg = GenerationConfig(**_case_cfg(kw))
        eng = _engine(gen, paged, bridge=bridge, **kw)
        got = _serve_all(eng, cfg)
        eng.close()
        ref = _engine(solo, paged, **kw)
        record[name] = {"tp": got, "solo": _serve_all(ref, cfg)}
        ref.close()
    record["preempt"] = _preempt(gen, solo, bridge)
    record["adapter"] = _adapter_rows(gen, solo, bridge, outdir)
    record["swap"] = _hot_swap(gen, bridge)  # last: the weights change
    bridge.stop()
    _write(outdir, "engines_rank0.json", record)


def _fault_main(outdir) -> None:
    """Rank 1's third mirrored decode step raises: it must exit non-zero,
    and rank 0's server must answer /healthz with 503."""
    gen, _ = _generators()
    if distributed.process_index():
        step, calls = gen.paged_step, [0]

        def planted(*a, **kw):
            calls[0] += 1
            if calls[0] == 3:
                raise RuntimeError("planted follower fault")
            return step(*a, **kw)

        gen.paged_step = planted
        follow_slots(gen)  # raises: the process exits non-zero
        return
    from llm_fine_tune_distributed_tpu_torch.infer.server import build_server

    bridge = SlotBridge(gen)
    httpd, eng = build_server(gen, port=0, engine="paged", quantize_kv="int8", slots=4,
                              kv_buf_len=128, kv_block_len=16, prefill_chunk=32,
                              prompt_bucket=16, bridge=bridge, flight_dir=None,
                              restart_backoff_s=0.01)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    body = json.dumps(QUESTION).encode()
    try:
        urllib.request.urlopen(urllib.request.Request(base + "/v1/generate", data=body),
                               timeout=120)
        status = 200
    except urllib.error.HTTPError as e:
        status = e.code
    t0 = time.monotonic()
    health = 200
    while health == 200 and time.monotonic() - t0 < 60:
        # the failed tick's restart finds the follower gone at its first
        # broadcast: from then on the bridge is wedged
        try:
            urllib.request.urlopen(base + "/healthz", timeout=30)
            time.sleep(0.05)
        except urllib.error.HTTPError as e:
            health, payload = e.code, json.loads(e.read())
    _write(outdir, "fault_rank0.json", {"generate": status, "healthz": health, "payload": payload,
                                        "wedged": bridge.wedged, "healthy": eng.healthy,
                                        "seconds_to_503": time.monotonic() - t0})
    sys.stdout.flush()
    os._exit(0)  # the group lost a rank: no collective teardown


# --------------------------------------------------------------- the tests


@pytest.fixture(scope="module")
def jax_setup(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.models import hf_io as jax_hf_io
    from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_preset
    from llm_fine_tune_distributed_tpu.models.configs import to_hf_dict
    from llm_fine_tune_distributed_tpu.models.transformer import init_params
    from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree

    mc = jax_preset("tiny")
    params = init_params(jax.random.PRNGKey(0), mc, dtype=jnp.float32)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 10.0 if path[-1].key == "kernel" else x, params)
    outdir = tmp_path_factory.mktemp("sharded_engine")
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(params)).items()}
    np.savez(os.path.join(outdir, "params.npz"), **flat)
    model_dir = outdir / "best_model"
    jax_hf_io.save_hf_checkpoint(jax.device_get(params), str(model_dir))
    with open(model_dir / "config.json", "w") as f:
        json.dump(to_hf_dict(mc), f)
    TOK.save_pretrained(str(model_dir))
    from tests.test_adapters import _make_adapter

    _make_adapter(params, str(outdir / "adapters" / "t1"), seed=1, rank=4)
    return mc, params, outdir


@pytest.fixture(scope="module")
def engines(jax_setup):
    outdir = jax_setup[2]
    _launch("engines", outdir)
    out = []
    for rank in range(2):
        with open(os.path.join(outdir, f"engines_rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


def _jax_tp_engine(jax_setup, paged, **kw):
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator
    from llm_fine_tune_distributed_tpu.infer.engine import (
        ContinuousBatchingEngine as JaxContinuous,
        PagedContinuousBatchingEngine as JaxPaged,
    )
    from llm_fine_tune_distributed_tpu.infer.generate import make_tp_mesh as jax_tp_mesh

    mc, params = jax_setup[0], jax_setup[1]
    gen = JaxGenerator(params, mc, TOK, compute_dtype=jnp.float32, eos_token_ids=[],
                       mesh=jax_tp_mesh(2, mc))
    if paged:
        return gen, JaxPaged(gen, **kw)
    return gen, JaxContinuous(gen, **kw)


def test_kv_leaves_and_int8_scales_hold_the_ranks_heads(jax_setup, engines):
    """Dense cache [4, 128, hkv, d] and int8 pool codes and scales: the
    rank's kv head, the JAX addressable shard's shape."""
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator
    from llm_fine_tune_distributed_tpu.infer.generate import make_tp_mesh as jax_tp_mesh

    mc, params = jax_setup[0], jax_setup[1]
    jgen = JaxGenerator(params, mc, TOK, compute_dtype=jnp.float32, eos_token_ids=[],
                        mesh=jax_tp_mesh(2, mc))
    cache, _ = jgen.init_slot_state(4, 128)
    pool, _ = jgen.init_paged_state(4, 32, 16, "int8")
    want = {"dense_k": cache["layers"]["0"]["k"], "pool_k": pool["layers"]["0"]["k"],
            "pool_k_scale": pool["layers"]["0"]["k_scale"]}
    for rec in engines:
        for name, leaf in want.items():
            assert tuple(rec[name]) == leaf.addressable_shards[0].data.shape, name
    assert engines[0]["dense_k"][2] * 2 == CFG.num_kv_heads


@pytest.mark.parametrize("case", list(CASES))
def test_tp_engine_greedy_equals_solo(engines, case):
    rec = engines[0][case]
    assert rec["tp"] == rec["solo"]
    if case != "paged-int8":  # a freed int8 block keeps its scale: history counts there
        assert rec["tp"][:3] == rec["tp"][3:]  # the prefix-hit pass too


@pytest.mark.parametrize("case", ["dense"])  # paged int8: the server case below
def test_tp_engine_greedy_equals_the_jax_tp_engine(jax_setup, engines, case):
    from llm_fine_tune_distributed_tpu.infer import GenerationConfig as JaxCfg

    paged, kw = CASES[case]
    geometry = dict(slots=4, buf_len=128, prompt_bucket=16)
    if paged:
        geometry.update(block_len=16, prefill_chunk=32)
    _, eng = _jax_tp_engine(jax_setup, paged, **geometry, **kw)
    cfg = JaxCfg(**_case_cfg(kw))
    want = [eng.submit_full(TOK.encode(t), cfg, seed=0, timeout=240).result
            for _ in range(2) for t in TEXTS]
    assert engines[0][case]["tp"] == want


def test_tp_adapter_rows_match_merged_solo(engines):
    """A resident LoRA adapter on the tp=2 engine emits the merged weights'
    solo tokens, and a base request through pool slot 0 the base's."""
    rec = engines[0]["adapter"]
    assert rec["tp"] == rec["merged"]
    assert rec["base_tp"] == rec["base_solo"]


def test_tp_hot_swap_equals_a_solo_engine_on_the_swapped_weights(engines):
    rec = engines[0]["swap"]
    assert rec["updated"] == 1
    assert rec["tp"] == rec["solo"]
    assert rec["gathered_equal"]  # resident_params: every rank's slices put back whole


def test_tp_preempt_resume_equals_solo(engines):
    rec = engines[0]["preempt"]
    assert rec["tokens"] == rec["solo"]
    assert rec["preemptions"] >= 1


def test_make_tp_mesh_warns_on_kv_head_fallback():
    with pytest.warns(UserWarning, match="head replication"):
        with pytest.raises(ValueError, match="needs 4 processes"):
            make_tp_mesh(4, CFG)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="needs 2 processes"):
            make_tp_mesh(2, CFG)  # divides: silent


def test_an_engine_refuses_a_multi_process_generator_without_a_bridge():
    class Spanning:
        _multihost = True

    with pytest.raises(ValueError, match="without a slot bridge"):
        ContinuousBatchingEngine(Spanning())


def test_a_failed_follower_exits_nonzero_and_healthz_answers_503(jax_setup):
    outdir = jax_setup[2]
    _launch("fault", outdir, codes={1: 1})
    with open(os.path.join(outdir, "fault_rank0.json")) as f:
        rec = json.load(f)
    assert rec["generate"] >= 500 and rec["healthz"] == 503
    assert rec["wedged"] and not rec["healthy"]
    assert "wedged" in rec["payload"]["error"]


def _read_until(proc, marker, lines, timeout=120):
    """Collect ``proc``'s stdout lines (on a thread) until one has ``marker``."""
    found = threading.Event()

    def pump():
        for line in proc.stdout:
            lines.append(line)
            if marker in line:
                found.set()

    threading.Thread(target=pump, daemon=True).start()
    assert found.wait(timeout), "".join(lines)[-3000:]
    return next(line for line in lines if marker in line)


def test_tp2_server_answers_with_the_jax_tp_engines_tokens(jax_setup):
    """``python -m ...infer.server --tp 2 --device cpu --engine paged
    --quantize-kv int8`` in two ranks: rank 0 answers; /v1/stream's deltas
    are the answer; SIGTERM to rank 0 drains, releases rank 1, and both exit
    0."""
    from llm_fine_tune_distributed_tpu.infer import GenerationConfig as JaxCfg

    mc, _, outdir = jax_setup
    model_dir = str(outdir / "best_model")
    port = distributed.free_port()
    cmd = [sys.executable, "-m", "llm_fine_tune_distributed_tpu_torch.infer.server", "--tp", "2",
           "--device", "cpu", "--model-dir", model_dir, "--port", "0", "--engine", "paged",
           "--quantize-kv", "int8", "--flight-dir", ""] + SERVE_GEOMETRY
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=_env(rank, 2, port)) for rank in range(2)]
    lines = [[], []]
    try:
        listening = _read_until(procs[0], "listening on", lines[0])
        base = "http://127.0.0.1:" + listening.split("http://")[1].split(" ")[0].split(":")[1]
        req = urllib.request.Request(base + "/v1/generate", data=json.dumps(QUESTION).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            answer = json.loads(r.read())["answer"]
        host, p = base.split("//")[1].split(":")
        conn = http.client.HTTPConnection(host, int(p), timeout=120)
        conn.request("POST", "/v1/stream", body=json.dumps(QUESTION),
                     headers={"Content-Type": "application/json"})
        text = conn.getresponse().read().decode()
        conn.close()
        deltas = [json.loads(b.split("data: ", 1)[1]) for b in text.split("\n\n") if "data: " in b]
        # the window fallback of a speculative request is not in the tick
        # protocol: a K=0 slot engine under --tp 2 answers 400 (the JAX text)
        spec = urllib.request.Request(base + "/v1/generate",
                                      data=json.dumps({**QUESTION, "speculative": 2}).encode(),
                                      headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as refused:
            urllib.request.urlopen(spec, timeout=120)
        assert refused.value.code == 400
        assert "multi-host --tp slot engine" in refused.value.read().decode()
        procs[0].send_signal(signal.SIGTERM)
        codes = [proc.wait(timeout=120) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert codes == [0, 0], "".join(lines[0])[-3000:]
    assert "".join(d.get("delta", "") for d in deltas).strip() == answer
    assert deltas[-1] == {"done": True, "n_tokens": 8}
    gen, eng = _jax_tp_engine(jax_setup, True, slots=4, buf_len=256, block_len=16,
                              prefill_chunk=32, prompt_bucket=64, kv_quant="int8")
    ids = gen.encode_chat([{"role": "system", "content": QUESTION["system_prompt"]},
                           {"role": "user", "content": QUESTION["question"]}])
    want = eng.submit(ids, JaxCfg(max_new_tokens=8, do_sample=False), timeout=240)
    assert answer == gen.decode_reply(want)


if __name__ == "__main__":
    scenario, outdir = sys.argv[1], sys.argv[2]
    {"engines": _engines_main, "fault": _fault_main}[scenario](outdir)
