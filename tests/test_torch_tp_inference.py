"""Tensor-parallel decoding on the CPU (mirrors ``tests/test_tp_inference.py``):
the port's ``Generator(mesh=make_tp_mesh(tp))`` at tp 2 and 4, each rank a
gloo process, against the JAX ``Generator(mesh=make_tp_mesh(tp))`` on the
forced 8-device CPU mesh and against the port's own one-process decode,
and the same over NF4 weights with single-adapter LoRA leaves (quantized
whole by the JAX package, then sharded, as its server does) on a wider
``tiny`` whose row-parallel slices start on whole absmax blocks at tp 4.

Each world size is launched once for the module (``_launch`` runs this file
as a script, one process per rank; those processes import torch and the
port only): every rank writes its tokens and its parameter slices, and the
tests read them. The weights are the JAX package's seed-0 ``tiny`` init with
the kernels x10 (at the 0.02 init the tiny model repeats one token), carried
over by ``models/carry.params_from_jax``.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator, make_tp_mesh
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.models.carry import params_from_jax
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
from llm_fine_tune_distributed_tpu_torch.models.transformer import param_shapes
from llm_fine_tune_distributed_tpu_torch.parallel.sharding import kv_heads_of_rank
from llm_fine_tune_distributed_tpu_torch.runtime import distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 240
TOK = ByteChatMLTokenizer()
CFG = get_preset("tiny")
GREEDY = dict(max_new_tokens=12, do_sample=False, repetition_penalty=1.1)
TEXTS = ("hello world", "ab ab ab")
SPEC = dict(max_new_tokens=10, do_sample=False, repetition_penalty=1.0, speculative_lookup=3)
RAGGED = ("one", "two tokens here")
RAGGED_CFG = dict(max_new_tokens=6, do_sample=False, repetition_penalty=1.0)
# NF4 under --tp: o_proj's 256 and down_proj's 512 input rows split into
# whole 64-row absmax blocks at tp 2 and 4 (tiny's 64 and 128 do not)
NF4_CFG = CFG.replace(hidden_size=256, intermediate_size=512)
NF4_WIDE = dict(hidden_size=256, intermediate_size=512)
# (layer, module) -> LoRA leaves: column-parallel and row-parallel kernels
LORA_AT = (("0", "self_attn", "q_proj"), ("0", "self_attn", "o_proj"), ("1", "mlp", "down_proj"),
           ("1", "self_attn", "v_proj"))
LORA_RANK = 4


def _launch(scenario: str, outdir, world: int):
    """Run ``scenario`` of this file in ``world`` gloo processes; returns
    their outputs after every one exited 0."""
    port = distributed.free_port()
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
        env.update(distributed.rendezvous_env(rank, world, port), PYTHONPATH=ROOT,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), scenario, str(outdir)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
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
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out[-3000:]}\n{err[-6000:]}"
    return outs


def _port_params(outdir):
    flat = dict(np.load(os.path.join(outdir, "params.npz")))
    return params_from_jax(flat, CFG)


# ------------------------------------------------------------ rank processes


def _window(gen, rank):
    """The window engine over ``MultihostCoordinator`` on rank 0 (two
    greedy requests and a sampled one), rank 1 in ``follow`` until the
    coordinator stops it; rank 0's tokens."""
    from llm_fine_tune_distributed_tpu_torch.infer.batching import BatchingEngine
    from llm_fine_tune_distributed_tpu_torch.infer.multihost import MultihostCoordinator, follow

    if rank:
        follow(gen)
        return None
    coordinator = MultihostCoordinator(gen)
    eng = BatchingEngine(coordinator, max_batch=4, window_ms=10.0)
    greedy = GenerationConfig(**RAGGED_CFG)
    out = [eng.submit(TOK.encode(t), greedy, timeout=240) for t in RAGGED]
    out.append(eng.submit(TOK.encode("hello"), GenerationConfig(max_new_tokens=8, do_sample=True),
                          seed=3, timeout=240))
    eng.close()
    coordinator.stop()
    return {"tokens": out, "wedged": coordinator.wedged}


def _rank_main(outdir) -> None:
    """One rank: the tp-way Generator's tokens (greedy, sampled twice,
    speculative, a ragged batch), a one-process Generator's, and its
    parameter slices."""
    distributed.initialize_distributed(device="cpu")
    tp, rank = distributed.process_count(), distributed.process_index()
    params = _port_params(outdir)
    kw = dict(compute_dtype=torch.float32, eos_token_ids=[], device="cpu")
    solo = Generator(params, CFG, TOK, **kw)
    gen = Generator(params, CFG, TOK, mesh=make_tp_mesh(tp, CFG), **kw)
    out = {"greedy": [gen.generate_ids(TOK.encode(t), GenerationConfig(**GREEDY)) for t in TEXTS],
           "solo_greedy": [solo.generate_ids(TOK.encode(t), GenerationConfig(**GREEDY))
                           for t in TEXTS]}
    if tp == 2:
        sampled = GenerationConfig(max_new_tokens=8, do_sample=True)
        out["sampled"] = [gen.generate_ids(TOK.encode("hello"), sampled, seed=3) for _ in range(2)]
        out["spec"] = gen.generate_ids(TOK.encode("ab ab ab ab"), GenerationConfig(**SPEC))
        out["solo_spec"] = solo.generate_ids(TOK.encode("ab ab ab ab"), GenerationConfig(**SPEC))
        prompts = [TOK.encode(t) for t in RAGGED]
        out["ragged"] = gen.generate_batch(prompts, GenerationConfig(**RAGGED_CFG))
        out["solo_ragged"] = solo.generate_batch(prompts, GenerationConfig(**RAGGED_CFG))
    if tp == 2:
        out["window"] = _window(gen, rank)
    nf4 = params_from_jax(dict(np.load(os.path.join(outdir, "nf4_params.npz"))), NF4_CFG)
    nf4_solo = Generator(nf4, NF4_CFG, TOK, **kw)
    nf4_gen = Generator(nf4, NF4_CFG, TOK, mesh=make_tp_mesh(tp, NF4_CFG), **kw)
    out["nf4_greedy"] = [nf4_gen.generate_ids(TOK.encode(t), GenerationConfig(**GREEDY))
                         for t in TEXTS]
    out["nf4_solo_greedy"] = [nf4_solo.generate_ids(TOK.encode(t), GenerationConfig(**GREEDY))
                              for t in TEXTS]
    torch.save(nf4_gen.params, os.path.join(outdir, f"tp{tp}_rank{rank}_nf4.pt"))
    out["shard_config"] = [gen.shard_config.num_heads, gen.shard_config.num_kv_heads,
                           gen.shard_config.intermediate_size, gen.shard_config.vocab_size]
    torch.save(gen.params, os.path.join(outdir, f"tp{tp}_rank{rank}.pt"))
    with open(os.path.join(outdir, f"tp{tp}_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.barrier("cpu")
    distributed.destroy()


# --------------------------------------------------------------- the tests


@pytest.fixture(scope="module")
def jax_setup(tmp_path_factory):
    """The JAX seed-0 tiny params (kernels x10), written for the ranks."""
    import jax
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_preset
    from llm_fine_tune_distributed_tpu.models.transformer import init_params
    from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree

    mc = jax_preset("tiny")
    params = init_params(jax.random.PRNGKey(0), mc, dtype=jnp.float32)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 10.0 if path[-1].key == "kernel" else x, params)
    outdir = tmp_path_factory.mktemp("tp_inference")
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(params)).items()}
    np.savez(os.path.join(outdir, "params.npz"), **flat)
    nf4_mc, nf4_params = _jax_nf4_params()
    nf4_flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(nf4_params)).items()}
    np.savez(os.path.join(outdir, "nf4_params.npz"), **nf4_flat)
    return mc, params, flat, outdir, (nf4_mc, nf4_params, nf4_flat)


def _jax_nf4_params():
    """The wider tiny's seed-1 JAX init (kernels x10), LoRA leaves on the
    ``LORA_AT`` modules (B nonzero), then the JAX ``maybe_quantize(...,
    "nf4")`` over the block linears, the adapters left in f32."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_preset
    from llm_fine_tune_distributed_tpu.models.transformer import init_params
    from llm_fine_tune_distributed_tpu.ops.int8 import maybe_quantize

    mc = dataclasses.replace(jax_preset("tiny"), **NF4_WIDE)
    params = init_params(jax.random.PRNGKey(1), mc, dtype=jnp.float32)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 10.0 if path[-1].key == "kernel" else x, params)
    rng = np.random.default_rng(5)
    for layer, block, module in LORA_AT:
        leaf = params["model"]["layers"][layer][block][module]
        n_in, n_out = leaf["kernel"].shape
        leaf["lora_a"] = jnp.asarray(rng.normal(0, 0.3, (n_in, LORA_RANK)), jnp.float32)
        leaf["lora_b"] = jnp.asarray(rng.normal(0, 0.3, (LORA_RANK, n_out)), jnp.float32)
        leaf["lora_scale"] = jnp.asarray(2.0, jnp.float32)
    return mc, maybe_quantize(params, "nf4")


@pytest.fixture(scope="module")
def ranks(jax_setup):
    """{tp: [rank record]} of one launch per world size, both at once."""
    outdir = jax_setup[3]
    errors = []

    def launch(tp):
        try:
            _launch("rank", outdir, tp)
        except BaseException as e:  # re-raised below, on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=launch, args=(tp,)) for tp in (2, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    out = {}
    for tp in (2, 4):
        out[tp] = []
        for r in range(tp):
            with open(os.path.join(outdir, f"tp{tp}_rank{r}.json")) as f:
                rec = json.load(f)
            rec["params"] = torch.load(os.path.join(outdir, f"tp{tp}_rank{r}.pt"))
            out[tp].append(rec)
    return out


def _jax_generator(jax_setup, tp=None, nf4=False):
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator
    from llm_fine_tune_distributed_tpu.infer.generate import make_tp_mesh as jax_tp_mesh

    mc, params = jax_setup[4][:2] if nf4 else jax_setup[:2]
    mesh = jax_tp_mesh(tp, mc) if tp else None
    return JaxGenerator(params, mc, TOK, compute_dtype=jnp.float32, eos_token_ids=[], mesh=mesh)


def _jax_cfg(**kw):
    from llm_fine_tune_distributed_tpu.infer import GenerationConfig as JaxCfg

    return JaxCfg(**kw)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_greedy_matches_jax_tp_and_solo(jax_setup, ranks, tp):
    jgen = _jax_generator(jax_setup, tp)
    want = [jgen.generate_ids(TOK.encode(t), _jax_cfg(**GREEDY)) for t in TEXTS]
    for rec in ranks[tp]:
        assert rec["greedy"] == want == rec["solo_greedy"]


@pytest.mark.parametrize("tp", [2, 4])
def test_each_rank_holds_the_jax_addressable_shard(jax_setup, ranks, tp):
    """Every rank's leaf equals, exactly, the shard the JAX package places
    on the device with its tensor coordinate; at tp 4 (tiny has 2 kv heads)
    k/v keep the head the rank's query head reads, where the JAX package
    splits the head's columns."""
    import jax

    from llm_fine_tune_distributed_tpu.infer.generate import make_tp_mesh as jax_tp_mesh
    from llm_fine_tune_distributed_tpu.parallel.sharding import shard_params as jax_shard
    from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree

    mc, params, flat = jax_setup[0], jax_setup[1], jax_setup[2]
    mesh = jax_tp_mesh(tp)
    sharded = flatten_tree(jax_shard(params, mesh))
    axis = list(mesh.axis_names).index("tensor")
    coord = {d: int(np.argwhere(mesh.devices == d)[0][axis]) for d in mesh.devices.flat}
    d = mc.resolved_head_dim
    for rank, rec in enumerate(ranks[tp]):
        assert set(rec["params"]) == set(flat)
        for name, leaf in sharded.items():
            got = rec["params"][name].numpy()
            if tp > mc.num_kv_heads and name.endswith(("k_proj.kernel", "v_proj.kernel")):
                first, n = kv_heads_of_rank(CFG, tp, rank)
                np.testing.assert_array_equal(got, flat[name][:, first * d: (first + n) * d])
                continue
            shard = next(s for s in leaf.addressable_shards if coord[s.device] == rank)
            want = np.asarray(jax.device_get(shard.data))
            assert got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    hkv = max(CFG.num_kv_heads // tp, 1)
    assert ranks[tp][0]["shard_config"] == [CFG.num_heads // tp, hkv,
                                            CFG.intermediate_size // tp, CFG.vocab_size // tp]


def _jax_shards(params, tp):
    """{name: [the JAX addressable shard of each tensor coordinate]} of
    ``shard_params(params)`` on the JAX tp mesh."""
    import jax

    from llm_fine_tune_distributed_tpu.infer.generate import make_tp_mesh as jax_tp_mesh
    from llm_fine_tune_distributed_tpu.parallel.sharding import shard_params as jax_shard
    from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree

    mesh = jax_tp_mesh(tp)
    axis = list(mesh.axis_names).index("tensor")
    coord = {d: int(np.argwhere(mesh.devices == d)[0][axis]) for d in mesh.devices.flat}
    out = {}
    for name, leaf in flatten_tree(jax_shard(params, mesh)).items():
        shards = {coord[s.device]: np.asarray(jax.device_get(s.data)) for s in leaf.addressable_shards}
        out[name] = [shards[r] for r in range(tp)]
    return out


@pytest.mark.parametrize("tp", [2, 4])
def test_nf4_and_lora_leaves_are_the_jax_addressable_shards(jax_setup, ranks, tp):
    """Over the JAX-quantized tree: every rank's NF4 codes and absmax equal
    the JAX addressable shard of its tensor coordinate bit for bit (the
    double quantization's scale and offset whole), as every other leaf
    does; k/v at tp 4 keep the rank's kv head (the fallback). The JAX rules
    give LoRA leaves no tensor axis (each device computes the whole
    delta); the port's rank holds B's columns beside a column-parallel
    kernel and A's rows beside a row-parallel one, A and B whole
    otherwise."""
    _, params, flat = jax_setup[4]
    shards = _jax_shards(params, tp)
    d = NF4_CFG.resolved_head_dim
    assert any(k.endswith("kernel_absmax_q") for k in shards)

    def columns(module, whole, rank):
        if tp > NF4_CFG.num_kv_heads and module.endswith(("k_proj", "v_proj")):
            first, n = kv_heads_of_rank(NF4_CFG, tp, rank)
            return whole[:, first * d: (first + n) * d]
        n = whole.shape[1] // tp
        return whole[:, rank * n: (rank + 1) * n]

    for rank in range(tp):
        got = torch.load(os.path.join(jax_setup[3], f"tp{tp}_rank{rank}_nf4.pt"))
        assert set(got) == set(flat)
        for name, parts in shards.items():
            module, _, leaf = name.rpartition(".")
            mine = got[name].numpy()
            if leaf in ("lora_a", "lora_b"):
                row = module.endswith(("o_proj", "down_proj"))
                want = flat[name]
                if leaf == "lora_a" and row:
                    n = want.shape[0] // tp
                    want = want[rank * n: (rank + 1) * n]
                elif leaf == "lora_b" and not row:
                    want = columns(module, want, rank)
                np.testing.assert_array_equal(mine, want, err_msg=name)
                continue
            if tp > NF4_CFG.num_kv_heads and module.endswith(("k_proj", "v_proj")) and mine.ndim == 2:
                np.testing.assert_array_equal(mine, columns(module, flat[name], rank))
                continue
            assert mine.shape == parts[rank].shape, name
            np.testing.assert_array_equal(mine, parts[rank], err_msg=name)


@pytest.mark.parametrize("tp", [2, 4])
def test_nf4_lora_tp_greedy_matches_jax_tp_and_solo(jax_setup, ranks, tp):
    """``--quantize nf4`` with LoRA leaves under --tp: greedy tokens equal
    the JAX TP generator's over the same quantized tree, and one process's."""
    jgen = _jax_generator(jax_setup, tp, nf4=True)
    want = [jgen.generate_ids(TOK.encode(t), _jax_cfg(**GREEDY)) for t in TEXTS]
    for rec in ranks[tp]:
        assert rec["nf4_greedy"] == want == rec["nf4_solo_greedy"]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("module,shape", [
    ("model.layers.0.self_attn.q_proj", (256, 256)),
    ("model.layers.0.self_attn.k_proj", (256, 128)),
    ("model.layers.0.self_attn.o_proj", (256, 256)),
    ("model.layers.0.mlp.down_proj", (512, 256)),
    ("model.layers.0.mlp.up_proj", (256, 512)),
])
def test_nf4_slice_origin_dequant_is_whole_then_slice(module, shape, tp):
    """A rank's slice dequantized from its origin in the whole absmax is
    bit for bit the whole weight dequantized, then sliced: the 256-entry
    groups of the flat absmax straddle the column slices (k_proj's 64 or 32
    columns a rank), and the row slices start on whole blocks."""
    from llm_fine_tune_distributed_tpu_torch.ops.nf4 import dequantize_nf4, quantize_nf4
    from llm_fine_tune_distributed_tpu_torch.parallel.sharding import (
        nf4_slice_origin,
        shard_leaf,
    )

    gen = torch.Generator().manual_seed(11)
    w = torch.randn(shape, generator=gen)
    q = quantize_nf4(w)
    whole = dequantize_nf4(q, torch.float32)
    for rank in range(tp):
        part = {s: shard_leaf(f"{module}.kernel_{s}", t, NF4_CFG, tp, rank) for s, t in q.items()}
        origin = nf4_slice_origin(module, part["absmax_q"].shape, NF4_CFG, tp, rank)
        got = dequantize_nf4(part, torch.float32, origin)
        want = shard_leaf(module + ".kernel", whole, NF4_CFG, tp, rank)
        assert got.shape == want.shape != whole.shape
        assert torch.equal(got, want), (module, rank)
        assert torch.equal(part["absmax_scale"], q["absmax_scale"])


def test_nf4_row_slice_off_a_block_is_refused():
    """tiny's o_proj (64 input rows, one 64-row absmax block) cannot give
    each of 2 ranks whole blocks: refused, naming the JAX rule."""
    from llm_fine_tune_distributed_tpu_torch.ops.nf4 import quantize_nf4
    from llm_fine_tune_distributed_tpu_torch.parallel.sharding import shard_leaf

    q = quantize_nf4(torch.randn(64, 64))
    name = "model.layers.0.self_attn.o_proj.kernel_absmax_q"
    with pytest.raises(ValueError, match="_validate_spec"):
        shard_leaf(name, q["absmax_q"], CFG, 2, 0)
    assert shard_leaf(name.replace("o_proj", "q_proj"), q["absmax_q"], CFG, 2, 1).shape == (1, 32)


def test_tp_sampled_deterministic_same_on_every_rank(ranks):
    a, b = ranks[2][0]["sampled"]
    assert a == b and all(0 <= t < CFG.vocab_size for t in a)
    assert ranks[2][1]["sampled"] == [a, a]  # every rank drew the same tokens


def test_tp_speculative_greedy_matches(jax_setup, ranks):
    jgen = _jax_generator(jax_setup, 2)
    want = jgen.generate_ids(TOK.encode("ab ab ab ab"), _jax_cfg(**SPEC))
    for rec in ranks[2]:
        assert rec["spec"] == want == rec["solo_spec"]


def test_window_engine_over_the_coordinator(ranks):
    """Rank 0's window engine broadcasts each batch, rank 1 follows until
    the coordinator's stop: greedy rows are the solo ones, the sampled row
    the tp generator's own draw."""
    rec = ranks[2][0]
    greedy = rec["window"]["tokens"][:2]
    assert [g for g in greedy] == [r for r in rec["solo_ragged"]]
    assert rec["window"]["tokens"][2] == rec["sampled"][0]
    assert not rec["window"]["wedged"]


def test_tp_batched_ragged(jax_setup, ranks):
    jgen = _jax_generator(jax_setup, 2)
    want = jgen.generate_batch([TOK.encode(t) for t in RAGGED], _jax_cfg(**RAGGED_CFG))
    for rec in ranks[2]:
        assert rec["ragged"] == want == rec["solo_ragged"]


def test_tp_without_a_group_raises_and_the_fallback_warns():
    """``--tp 2`` with no process group raises (nothing carries on at tp 1),
    and a tp that does not divide the kv heads warns first."""
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_tp_mesh(2, CFG)
    with pytest.warns(UserWarning, match="head replication"):
        with pytest.raises(ValueError, match="needs 4 processes"):
            make_tp_mesh(4, CFG)
    with pytest.raises(ValueError, match="straddle"):
        make_tp_mesh(3, CFG.replace(num_heads=12, num_kv_heads=2))  # 4 heads a rank, G 6
    assert make_tp_mesh(1).tensor_group is None  # one process: no collective


def test_ask_cli_tp2_answers_as_one_process(jax_setup, tmp_path, capsys):
    """``python -m ...ask_tuned_model --tp 2`` in two gloo ranks: every rank
    generates (the forward's collectives keep them in step), rank 0 alone
    prints, and its answer is one process's; its weights are half the
    matrices plus the norms."""
    from llm_fine_tune_distributed_tpu_torch.infer.cli import run_ask_cli
    from llm_fine_tune_distributed_tpu_torch.models.configs import to_hf_dict
    from llm_fine_tune_distributed_tpu_torch.models.hf_io import save_hf_checkpoint

    model_dir = tmp_path / "model"
    save_hf_checkpoint(_port_params(jax_setup[3]), str(model_dir))
    with open(model_dir / "config.json", "w") as f:
        json.dump(to_hf_dict(CFG), f)
    TOK.save_pretrained(str(model_dir))
    argv = ["--device", "cpu", "--model-dir", str(model_dir), "--greedy", "--max-new-tokens",
            "8", "How many cups in a gallon?"]
    port = distributed.free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
        env.update(distributed.rendezvous_env(rank, 2, port), PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "llm_fine_tune_distributed_tpu_torch.ask_tuned_model",
             "--tp", "2"] + argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    outs = [p.communicate(timeout=LAUNCH_TIMEOUT_S) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert run_ask_cli(argv, description="", default_model_dir="", model_dir_env="MODEL_DIR",
                       missing_dir_help="") == 0
    solo = capsys.readouterr().out

    def line(text, prefix):
        return next(x for x in text.splitlines() if x.startswith(prefix))

    assert line(outs[0][0], "Answer:") == line(solo, "Answer:")
    assert "Answer:" not in outs[1][0]  # rank 1 prints nothing
    shapes = param_shapes(CFG)
    half = sum(4 * int(np.prod(v)) // (1 if len(v) == 1 else 2) for v in shapes.values())
    assert f"{half} bytes of weights" in line(outs[0][0], "Loaded in")


@pytest.mark.parametrize("shape", [(4, 128, 2, 16), (32, 16, 2, 16), (32, 2), (4, 128, 3, 16)])
@pytest.mark.parametrize("leaf", ["k", "v", "k_scale", "v_scale", "pos"])
def test_kv_cache_spec_is_the_jax_rule(leaf, shape):
    """The KV rules the cache's head dim follows, against the JAX
    ``kv_cache_spec`` on a tp=2 mesh (an axis that does not divide the heads
    is dropped, a leaf of another rank or name is replicated)."""
    from llm_fine_tune_distributed_tpu.infer.generate import make_tp_mesh as jax_tp_mesh
    from llm_fine_tune_distributed_tpu.parallel.sharding import kv_cache_spec as jax_spec
    from llm_fine_tune_distributed_tpu_torch.parallel.sharding import kv_cache_spec

    want = tuple(jax_spec(f"layers/0/{leaf}", shape, jax_tp_mesh(2)))
    assert kv_cache_spec(f"layers.0.{leaf}", shape, {"tensor": 2}) == want


@pytest.mark.parametrize("argv,message", [
    (["--tp", "2", "--replicas", "2"], "multi-host --tp serving runs ONE sharded engine"),
    (["--tp", "2", "--max-replicas", "3"], "multi-host --tp serving runs ONE sharded engine"),
    (["--tp", "0"], "--tp must be >= 1"),
], ids=["replicas", "max_replicas", "zero"])
def test_server_refuses_before_loading(tmp_path, capsys, argv, message):
    """The JAX server's fleet refusal under a multi-process --tp stops the
    server before any weight loads (the model directory does not even
    exist)."""
    from llm_fine_tune_distributed_tpu_torch.infer import server

    with pytest.raises(SystemExit) as exc:
        server.main(["--model-dir", str(tmp_path / "absent"), "--device", "cpu"] + argv)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


if __name__ == "__main__":
    scenario, outdir = sys.argv[1], sys.argv[2]
    {"rank": _rank_main}[scenario](outdir)
