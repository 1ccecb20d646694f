"""The port's data-parallel building blocks against the JAX package, on the
CPU: the loader's per-rank batches, the sharding rules, the mesh, the
process group's bootstrap, and, over two gloo processes, the loss's global
token mean on a batch whose ranks hold very different token counts, the
desync check, and the training entry point under
``python -m torch.distributed.run``.

The multi-process cases run this file as a script, one process per rank
(``_launch``); each process imports torch and the port only. Every launch
waits with a time limit, so a rank that hangs in a collective fails the
test instead of stalling it.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.config import MeshConfig, TrainConfig
from llm_fine_tune_distributed_tpu_torch.data.loader import SFTBatchLoader
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
from llm_fine_tune_distributed_tpu_torch.models.transformer import init_params, param_shapes
from llm_fine_tune_distributed_tpu_torch.parallel.freeze import trainable_mask
from llm_fine_tune_distributed_tpu_torch.parallel.sharding import fsdp_dim, leaf_spec
from llm_fine_tune_distributed_tpu_torch.runtime import distributed
from llm_fine_tune_distributed_tpu_torch.runtime.desync import DesyncMonitor
from llm_fine_tune_distributed_tpu_torch.runtime.mesh import (
    MESH_AXES,
    data_parallel_size,
    describe_mesh,
    make_mesh,
)
from llm_fine_tune_distributed_tpu_torch.parallel.optimizer import build_optimizer
from llm_fine_tune_distributed_tpu_torch.train.state import TrainState
from llm_fine_tune_distributed_tpu_torch.train.step import build_train_step, make_loss_fn
from llm_fine_tune_distributed_tpu_torch.utils.tree import split_by_mask

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 240
SEQ = 48


def _launch(scenario: str, outdir, world: int = 2, extra_env=None):
    """Run ``scenario`` of this file in ``world`` processes over gloo;
    returns their (stdout, stderr) by rank after every one exited 0."""
    port = distributed.free_port()
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
        env.update(distributed.rendezvous_env(rank, world, port), PYTHONPATH=ROOT,
                   OMP_NUM_THREADS="2", **(extra_env or {}))
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


# ---------------------------------------------------------------- (a) loader


def _arrays(n=37, seq=6, seed=0):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(0, 100, (n, seq)).astype(np.int32),
            "loss_mask": rng.randint(0, 2, (n, seq)).astype(np.int32),
            "attention_mask": np.ones((n, seq), np.int32),
            "lengths": np.full((n,), seq, np.int32)}


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("dp", [1, 2, 4])
def test_loader_rank_batches_equal_the_jax_loaders(dp, drop_last):
    """Every rank's batches of two epochs, by process index and by explicit
    rows, with and without shuffling, equal the JAX loader's."""
    from llm_fine_tune_distributed_tpu.data.loader import SFTBatchLoader as JaxLoader

    arrays = _arrays()
    for rank in range(dp):
        for shuffle in (True, False):
            kw = dict(per_device_batch_size=2, grad_accum_steps=2, data_parallel_size=dp,
                      process_index=rank, process_count=dp, seed=7, drop_last=drop_last,
                      shuffle=shuffle)
            for rows in ({}, dict(row_start=rank * 2, row_count=2)):
                ours, theirs = SFTBatchLoader(arrays, **kw, **rows), JaxLoader(arrays, **kw, **rows)
                assert ours.steps_per_epoch == theirs.steps_per_epoch
                for epoch in range(2):
                    got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
                    assert len(got) == len(want) > 0
                    for g, w in zip(got, want):
                        assert set(g) == set(w) == {"input_ids", "loss_mask", "attention_mask"}
                        for k in w:
                            np.testing.assert_array_equal(g[k], w[k])
                            assert g[k].shape == (2, 2, 6)


def test_loader_global_batch_is_the_ranks_columns():
    arrays = _arrays()
    loaders = [SFTBatchLoader(arrays, per_device_batch_size=3, grad_accum_steps=2,
                              data_parallel_size=2, process_index=r, process_count=2)
               for r in range(2)]
    for full, b0, b1 in zip(loaders[0].global_epoch(1), loaders[0].epoch(1), loaders[1].epoch(1)):
        for k in full:
            np.testing.assert_array_equal(np.concatenate([b0[k], b1[k]], axis=1), full[k])


# --------------------------------------------------------------- (b) specs


class _JaxMeshShape(types.SimpleNamespace):
    """What the JAX ``_validate_spec`` reads of a mesh: ``shape``."""


MESH_SHAPES = [
    dict(data=1, pipe=1, fsdp=2, tensor=1, seq=1, expert=1),
    dict(data=2, pipe=1, fsdp=4, tensor=2, seq=1, expert=1),
    dict(data=1, pipe=1, fsdp=8, tensor=1, seq=1, expert=1),
    dict(data=1, pipe=1, fsdp=3, tensor=4, seq=1, expert=1),
]


def _leaves(preset):
    """{dotted name: shape} of every leaf of the preset, plus the LoRA
    adapters of the default targets at rank 16."""
    shapes = dict(param_shapes(get_preset(preset)))
    for name, shape in list(shapes.items()):
        if name.endswith("_proj.kernel"):
            module = name[: -len(".kernel")]
            shapes[module + ".lora_a"] = (shape[0], 16)
            shapes[module + ".lora_b"] = (16, shape[1])
    for name in ("model.layers.0.self_attn.q_proj.kernel_nf4",
                 "model.layers.0.mlp.down_proj.kernel_absmax", "model.layers.0.mlp.up_proj.kernel_int8"):
        shapes[name] = (64, 128)
    return shapes


@pytest.mark.parametrize("preset", ["smollm3_3b", "tiny"])
def test_param_specs_equal_the_jax_rules(preset):
    """Every leaf's spec on four meshes, against the JAX rules on its JAX
    path (the port's names are the JAX model's paths, checked first)."""
    import jax

    from llm_fine_tune_distributed_tpu.models import configs as jax_configs
    from llm_fine_tune_distributed_tpu.models import transformer as jax_tf
    from llm_fine_tune_distributed_tpu.parallel.sharding import _validate_spec, param_spec
    from llm_fine_tune_distributed_tpu.utils.tree import flatten_dict

    abstract = jax.eval_shape(lambda: jax_tf.init_params(jax.random.PRNGKey(0),
                                                         jax_configs.get_preset(preset)))
    jax_shapes = {k: tuple(v.shape) for k, v in flatten_dict(abstract).items()}
    assert {k.replace(".", "/"): v for k, v in param_shapes(get_preset(preset)).items()} == jax_shapes
    for mesh_shape in MESH_SHAPES:
        jmesh = _JaxMeshShape(shape=mesh_shape)
        for name, shape in _leaves(preset).items():
            path = name.replace(".", "/")
            want = tuple(_validate_spec(param_spec(path, len(shape)), shape, jmesh))
            got = leaf_spec(name, shape, mesh_shape)
            assert got == want, (name, mesh_shape, got, want)
            dim = fsdp_dim(name, shape, mesh_shape)
            assert dim == (want.index("fsdp") if "fsdp" in want else None), name


def test_fsdp_dims_of_the_reference_recipe():
    """SmolLM3-3B's last two layers and the tied embedding (the default
    trainable set) at fsdp=2: every matrix is split, norms stay whole."""
    shapes = param_shapes(get_preset("smollm3_3b"))
    mesh_shape = dict(data=1, pipe=1, fsdp=2, tensor=1, seq=1, expert=1)
    dims = {k: fsdp_dim(k, s, mesh_shape) for k, s in shapes.items()}
    assert dims["model.embed_tokens.weight"] == 1
    assert dims["model.layers.35.self_attn.q_proj.kernel"] == 0
    assert dims["model.layers.35.self_attn.o_proj.kernel"] == 1
    assert dims["model.layers.35.mlp.down_proj.kernel"] == 1
    assert dims["model.norm.weight"] is None


# ---------------------------------------------------------------- (c) mesh


@pytest.mark.parametrize("config,world", [
    (MeshConfig(), 1), (MeshConfig(), 4), (MeshConfig(data=2, fsdp=-1), 4),
    (MeshConfig(data=-1, fsdp=2), 8), (MeshConfig(data=2, fsdp=2), 4), (MeshConfig(data=4, fsdp=1), 4),
])
def test_mesh_sizes_and_coords_equal_the_jax_mesh(config, world, eight_devices):
    """Sizes, the data-parallel size, and each rank's coordinates equal the
    position of device ``rank`` in the JAX mesh over ``world`` devices."""
    from llm_fine_tune_distributed_tpu.config import MeshConfig as JaxMeshConfig
    from llm_fine_tune_distributed_tpu.runtime import mesh as jax_mesh

    jcfg = JaxMeshConfig(**{a: getattr(config, a) for a in MESH_AXES})
    jm = jax_mesh.make_mesh(jcfg, eight_devices[:world])
    for rank in range(world):
        m = make_mesh(config, world=world, rank=rank)
        assert m.shape == dict(jm.shape)
        assert data_parallel_size(m) == jax_mesh.data_parallel_size(jm)
        assert describe_mesh(m) == jax_mesh.describe_mesh(jm)
        pos = np.argwhere(jm.devices == eight_devices[rank])[0]
        assert m.coords == {a: int(pos[i]) for i, a in enumerate(jm.axis_names)}


@pytest.mark.parametrize("config,world", [
    (MeshConfig(data=3, fsdp=1), 4), (MeshConfig(data=-1, fsdp=-1), 4),
    (MeshConfig(data=3, fsdp=-1), 4), (MeshConfig(data=2, fsdp=1), 1),
])
def test_mesh_errors_equal_the_jax_mesh_configs(config, world):
    from llm_fine_tune_distributed_tpu.config import MeshConfig as JaxMeshConfig

    jcfg = JaxMeshConfig(**{a: getattr(config, a) for a in MESH_AXES})
    with pytest.raises(ValueError):
        jcfg.axis_sizes(world)
    with pytest.raises(ValueError):
        make_mesh(config, world=world, rank=0)


@pytest.mark.parametrize("axis", ["tensor", "seq", "pipe", "expert"])
def test_unported_mesh_axes_raise(axis):
    with pytest.raises(NotImplementedError, match=axis):
        make_mesh(MeshConfig(data=1, fsdp=1, **{axis: 2}), world=2, rank=0)
    with pytest.raises(NotImplementedError, match=axis):  # an axis of -1 that takes ranks
        make_mesh(MeshConfig(data=1, fsdp=1, **{axis: -1}), world=2, rank=0)


def test_heartbeat_is_refused(monkeypatch):
    """``heartbeat=True`` is ported (``check_supported`` takes it), and a
    detector that cannot start refuses the run: an explicit ``heartbeat``
    raises, the automatic one over processes prints and goes on."""
    from llm_fine_tune_distributed_tpu_torch.runtime import native
    from llm_fine_tune_distributed_tpu_torch.train import trainer as trainer_mod

    trainer_mod.check_supported(TrainConfig(heartbeat=True))
    monkeypatch.setattr(native, "load", lambda: None)
    monkeypatch.setattr(native, "build_error", lambda: "no compiler")

    class Stub:
        distributed = False
        device = torch.device("cpu")
        config = TrainConfig(heartbeat=True)

    with pytest.raises(RuntimeError, match="no compiler"):
        trainer_mod.SFTTrainer._start_detector(Stub())
    Stub.config = TrainConfig()
    assert trainer_mod.SFTTrainer._start_detector(Stub()) is None  # one process: off
    cfg = TrainConfig(desync_check_steps=5, heartbeat_port=1, heartbeat_timeout_ms=2)
    back = TrainConfig.from_dict(json.loads(json.dumps(cfg.to_dict())))
    assert (back.desync_check_steps, back.heartbeat_port, back.heartbeat_timeout_ms,
            back.heartbeat) == (5, 1, 2, False)


def test_one_process_is_a_no_op_and_the_backend_follows_the_device():
    info = distributed.initialize_distributed({"WORLD_SIZE": "1"}, device="cpu")
    assert not distributed.is_distributed()
    assert (info.process_index, info.process_count, info.platform) == (0, 1, "cpu")
    assert info.is_primary and distributed.is_primary_host()
    assert distributed.backend_for("cuda") == "nccl"
    assert distributed.backend_for(torch.device("cpu")) == "gloo"
    with pytest.raises(ValueError):
        distributed.backend_for("meta")
    # without a group every collective helper is the identity
    t = torch.arange(3.0)
    assert distributed.all_reduce_grads([t], torch.ones(1)).tolist() == [1.0]
    assert distributed.agree([True, False], "cpu") == [True, False]
    assert distributed.broadcast_int(5, "cpu") == 5
    assert distributed.device_preflight("cpu", verbose=False)["process"] == "0/1"


# ------------------------------------- (f) the global token mean, (i) desync


def _tiny_setup():
    """The tiny preset at f32 from seed 0, the default freeze, and a batch
    of 4 rows whose first two hold ~40 loss tokens each and last two 3."""
    mc = get_preset("tiny")
    tc = TrainConfig(model_preset="tiny", compute_dtype="float32", max_seq_length=SEQ,
                     gradient_accumulation_steps=1, per_device_batch_size=2,
                     scale_lr_by_data_parallel=False)
    params = init_params(mc, seed=0, dtype=torch.float32)
    trainable, frozen = split_by_mask(params, trainable_mask(params, mc, tc))
    rng = np.random.RandomState(1)
    ids = rng.randint(3, mc.vocab_size, (4, SEQ)).astype(np.int32)
    loss_mask = np.zeros((4, SEQ), np.int32)
    loss_mask[:2, 4:44] = 1
    loss_mask[2:, 5:8] = 1
    batch = {"input_ids": ids, "loss_mask": loss_mask,
             "attention_mask": np.ones((4, SEQ), np.int32)}
    return mc, tc, trainable, frozen, batch


def _global_step_outputs(mc, tc, trainable, frozen, batch):
    """(loss, {leaf: grad}) of the one-process token mean over ``batch``."""
    t = {k: v.detach().clone().requires_grad_(True) for k, v in trainable.items()}
    loss, _ = make_loss_fn(mc, tc)(t, frozen, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in t.items()}


def _scenario_loss_and_desync(outdir):
    """Rank r's step over rows [2r, 2r + 2) with the global token count;
    then the desync check in sync, with a value planted on rank 1, and with
    a NaN on rank 1."""
    distributed.initialize_distributed(device="cpu")
    rank = distributed.process_index()
    mc, tc, trainable, frozen, batch = _tiny_setup()
    trainable = {k: v.requires_grad_(True) for k, v in trainable.items()}
    opt = build_optimizer(tc, total_steps=1, data_parallel_size=2)
    state = TrainState(step=0, trainable=trainable, frozen=frozen, opt_state=opt.init(trainable))
    grads = {}
    orig_step = opt.step

    def capture(params, g, st, shards=None):
        grads.update({k: v.clone() for k, v in g.items()})
        return orig_step(params, g, st, shards)

    opt.step = capture
    tokens = np.array([batch["loss_mask"][:, 1:].sum()], np.float32)
    mine = {k: torch.from_numpy(v[2 * rank: 2 * rank + 2][None]) for k, v in batch.items()}
    _, metrics = build_train_step(mc, tc, opt)(state, mine, tokens)
    results = {"loss": float(metrics["loss"]), "grads": grads}
    monitor = DesyncMonitor(1)
    monitor.maybe_check(1, trainable)
    results["in_sync"] = list(monitor.last_checksums)
    for fault in ("planted", "nan"):
        bad = {k: v.detach().clone() for k, v in trainable.items()}
        if rank == 1:
            name = sorted(bad)[0]
            bad[name].view(-1)[0] += 1e-3 if fault == "planted" else float("nan")
        try:
            monitor.maybe_check(2, bad)
            results[fault] = "passed"
        except RuntimeError as e:
            results[fault] = str(e)
    torch.save(results, os.path.join(outdir, f"rank{rank}.pt"))
    distributed.destroy()


def test_global_token_mean_on_unequal_ranks_and_the_desync_check(tmp_path):
    """Two ranks whose rows hold 80 and 6 loss tokens: the summed loss and
    the reduced gradients equal the one-process token mean over all four
    rows; the naive mean of the ranks' own means misses it by far more
    than the tolerance. Then the desync check passes in sync, and a value
    planted on rank 1, or a NaN there, fails it on both ranks."""
    _launch("loss_and_desync", tmp_path)
    mc, tc, trainable, frozen, batch = _tiny_setup()
    want_loss, want_grads = _global_step_outputs(mc, tc, trainable, frozen, batch)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for got in ranks:
        assert abs(got["loss"] - want_loss) <= 1e-6 * abs(want_loss), (got["loss"], want_loss)
        for k, g in want_grads.items():
            torch.testing.assert_close(got["grads"][k], g, rtol=1e-5, atol=1e-6 * float(g.abs().max()))
    naive = np.mean([_global_step_outputs(mc, tc, trainable, frozen,
                                          {k: v[2 * r: 2 * r + 2] for k, v in batch.items()})[0]
                     for r in range(2)])
    assert abs(naive - want_loss) > 1e-3 * abs(want_loss), (naive, want_loss)
    sums = ranks[0]["in_sync"]
    assert len(sums) == 2 and sums[0] == sums[1] and ranks[1]["in_sync"] == sums
    for got in ranks:
        assert "desync" in got["planted"] and "desync" in got["nan"], got
        assert "nan" in got["nan"].lower()


# ------------------------------------------------------------- (l) the CLI


def test_cli_under_torch_distributed_run(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m ...cli
    --device cpu``: both ranks exit 0, rank 0 alone prints the banner and
    the result, and the artifacts say world 2 over fsdp=2."""
    data = tmp_path / "data"
    data.mkdir()
    with open(os.path.join(ROOT, "data", "final_qa_data_unique.jsonl")) as f:
        (data / "qa.jsonl").write_text("".join(next(f) for _ in range(40)))
    cfg = TrainConfig(model_name="random", model_preset="tiny", tokenizer_path="byte-chatml",
                      data_dir=str(data), dataset_file="qa.jsonl", output_dir=str(tmp_path / "out"),
                      epochs=1, eval_steps=2, max_seq_length=128, compute_dtype="float32",
                      per_device_batch_size=2, gradient_accumulation_steps=2,
                      system_prompt="You are a wilderness survival expert.",
                      desync_check_steps=1)
    cfg.save(str(tmp_path / "cfg.json"))
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(distributed.free_port()),
         "-m", "llm_fine_tune_distributed_tpu_torch.cli", "--config", str(tmp_path / "cfg.json"),
         "--device", "cpu"], capture_output=True, text=True, env=env, timeout=LAUNCH_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    assert proc.stdout.count("completed successfully") == 1
    assert proc.stdout.count("SFT on cpu x 2 processes") == 1
    summary = json.loads((tmp_path / "out" / "training_summary.json").read_text())
    assert summary["world_size"] == 2 and summary["distributed_training"] is True
    assert summary["mesh"]["fsdp"] == 2 and summary["training_samples"] == 36
    history = json.loads((tmp_path / "out" / "training_history.json").read_text())
    assert [h["step"] for h in history] == [1, 2, 4] and np.isfinite(summary["final_eval_loss"])
    assert (tmp_path / "out" / "best_model" / "model.safetensors").exists()


if __name__ == "__main__":
    torch.set_num_threads(2)
    {"loss_and_desync": _scenario_loss_and_desync}[sys.argv[1]](sys.argv[2])
