"""The port's LoRA forward and adapter files (``parallel/lora.py``, the LoRA
branches of ``models/transformer._linear``, ``models/carry``) against the
JAX package's, on the ``tiny`` preset in f32 with inputs from a numpy seed
and adapters the JAX ``save_lora_adapter`` wrote:

- ``_linear`` with a single adapter's leaves and with the registry's pools
  (a mixed ``adapter_idx``), on a plain and on an int8 kernel, within 1e-5
  of the JAX function; pooled slot-0 rows bitwise equal to the base;
- ``merge_lora``, ``strip_lora``, ``lora_state_dict`` and
  ``peft_adapter_state`` equal to the JAX functions', a PEFT directory
  written by either package read back by the other, and every refusal with
  the JAX message (``tests/test_lora.py``'s serving cases and the
  validation cases of ``tests/test_adapters.py``);
- ``params_from_jax`` carries the LoRA leaves: the adapted forward equals
  the JAX one;
- int8 weights and ``--adapter-dir``: the JAX registry's refusal, word for
  word.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu.config import TrainConfig
from llm_fine_tune_distributed_tpu.infer.adapters import AdapterRegistry as JaxRegistry
from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_get_preset
from llm_fine_tune_distributed_tpu.models.transformer import _linear as jax_linear
from llm_fine_tune_distributed_tpu.models.transformer import forward as jax_forward
from llm_fine_tune_distributed_tpu.models.transformer import init_params as jax_init_params
from llm_fine_tune_distributed_tpu.ops.int8 import quantize_params_int8 as jax_quantize_int8
from llm_fine_tune_distributed_tpu.parallel import lora as jax_lora
from llm_fine_tune_distributed_tpu_torch.infer.adapters import AdapterRegistry
from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
from llm_fine_tune_distributed_tpu_torch.models.hf_io import read_safetensors, write_safetensors
from llm_fine_tune_distributed_tpu_torch.models.transformer import _linear, forward
from llm_fine_tune_distributed_tpu_torch.ops.int8 import maybe_quantize, quantize_int8
from llm_fine_tune_distributed_tpu_torch.parallel import lora

CFG = get_preset("tiny")
JCFG = jax_get_preset("tiny")
TOL = 1e-5


def _flat(tree):
    """The JAX tree's leaves by flat name, in the tree's own order (the
    order its walks visit modules in, and so the one its errors follow)."""
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def _bump(tree, seed):
    """Non-zero B (a fresh LoRA init has B = 0: every delta would vanish)."""
    counter = [seed]

    def walk(node):
        if isinstance(node, dict):
            if "lora_b" in node:
                node = dict(node)
                rs = np.random.RandomState(counter[0])
                counter[0] += 1
                node["lora_b"] = jnp.asarray(rs.normal(0.0, 0.02, node["lora_b"].shape),
                                             jnp.float32)
                return node
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(tree)


def _jax_adapter(base, outdir, seed, rank=4, alpha=8.0):
    params = _bump(jax_lora.add_lora_params(base, jax.random.PRNGKey(seed), rank=rank,
                                            alpha=alpha), seed)
    jax_lora.save_lora_adapter(params, outdir,
                               TrainConfig(freeze_strategy="lora", lora_rank=rank,
                                           lora_alpha=alpha))
    return params


@pytest.fixture(scope="module")
def jbase():
    return jax_init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)


@pytest.fixture(scope="module")
def base(jbase):
    return params_from_jax(_flat(jbase), CFG)


@pytest.fixture(scope="module")
def adapter_dir(jbase, tmp_path_factory):
    """t1 and t2 at rank 4, t3 at rank 2 (zero-padded into the rank-4 pool)."""
    root = tmp_path_factory.mktemp("lora_adapters")
    for name, seed, rank in (("t1", 1, 4), ("t2", 2, 4), ("t3", 3, 2)):
        _jax_adapter(jbase, str(root / name), seed, rank=rank)
    return str(root)


def _ids(b=2, s=16):
    return np.random.RandomState(1).randint(0, CFG.vocab_size, (b, s)).astype(np.int32)


def _module_inputs(kind, seed=0, d_in=64, d_out=48, r=4, n=3, b=3, s=5):
    """One linear module's leaves (numpy) and an input batch."""
    rs = np.random.RandomState(seed)
    w = rs.normal(0, 0.05, (d_in, d_out)).astype(np.float32)
    leaves = {"bias": rs.normal(0, 0.05, (d_out,)).astype(np.float32)}
    if kind == "kernel":
        leaves["kernel"] = w
    else:
        q = quantize_int8(torch.from_numpy(w))
        leaves["kernel_int8"] = q["int8"].numpy()
        leaves["kernel_int8_scale"] = q["int8_scale"].numpy()
    single = {"lora_a": rs.normal(0, 0.1, (d_in, r)).astype(np.float32),
              "lora_b": rs.normal(0, 0.1, (r, d_out)).astype(np.float32),
              "lora_scale": np.asarray(2.0, np.float32)}
    pools = {"lora_a_pool": rs.normal(0, 0.1, (n, d_in, r)).astype(np.float32),
             "lora_b_pool": rs.normal(0, 0.1, (n, r, d_out)).astype(np.float32),
             "lora_scale_pool": np.asarray([0.0, 2.0, 0.5], np.float32)}
    pools["lora_a_pool"][0] = 0.0  # slot 0: the identity adapter
    pools["lora_b_pool"][0] = 0.0
    x = rs.normal(0, 1.0, (b, s, d_in)).astype(np.float32)
    return leaves, single, pools, x


def _port_linear(x, leaves, adapter_idx=None):
    params = {f"m.{k}": torch.from_numpy(np.array(v)) for k, v in leaves.items()}
    idx = None if adapter_idx is None else torch.as_tensor(adapter_idx, dtype=torch.long)
    return _linear(torch.from_numpy(x), params, "m", torch.float32, adapter_idx=idx).numpy()


@pytest.mark.parametrize("kind", ["kernel", "kernel_int8"])
def test_linear_single_adapter_matches_jax(kind):
    leaves, single, _, x = _module_inputs(kind)
    both = {**leaves, **single}
    want = np.asarray(jax_linear(jnp.asarray(x), {k: jnp.asarray(v) for k, v in both.items()},
                                 jnp.float32))
    got = _port_linear(x, both)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert np.abs(got - _port_linear(x, leaves)).max() > 1e-3  # the delta is real


@pytest.mark.parametrize("kind", ["kernel", "kernel_int8"])
def test_linear_pooled_matches_jax_and_slot_zero_is_the_base(kind):
    leaves, _, pools, x = _module_inputs(kind)
    both = {**leaves, **pools}
    idx = np.array([2, 0, 1], np.int32)
    want = np.asarray(jax_linear(jnp.asarray(x), {k: jnp.asarray(v) for k, v in both.items()},
                                 jnp.float32, adapter_idx=jnp.asarray(idx)))
    got = _port_linear(x, both, idx)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    plain = _port_linear(x, leaves)
    np.testing.assert_array_equal(got[1], plain[1])  # slot 0: bit for bit
    assert np.abs(got[0] - plain[0]).max() > 1e-3 and np.abs(got[2] - plain[2]).max() > 1e-3
    # without adapter_idx the pools are not read at all
    np.testing.assert_array_equal(_port_linear(x, both), plain)


def test_pooled_forward_with_mixed_rows_matches_jax(jbase, base, adapter_dir):
    """A full forward over both registries' pools, rows on t1, the base and
    t3 (rank 2 in a rank-4 pool): within 1e-5 of the JAX forward, the base
    row bitwise equal to the port's own base forward."""
    jreg = JaxRegistry(jbase, adapter_dir, max_adapters=4)
    reg = AdapterRegistry(base, adapter_dir, max_adapters=4)
    slots = [reg.acquire(n) for n in ("t1", "t3")]
    assert slots == [jreg.acquire(n) for n in ("t1", "t3")]
    ids = _ids(3)
    idx = np.array([slots[0], 0, slots[1]], np.int32)
    want, _ = jax_forward(jreg.params, jnp.asarray(ids), JCFG, compute_dtype=jnp.float32,
                          adapter_idx=jnp.asarray(idx))
    got, _ = forward(reg.params, torch.from_numpy(ids).long(), CFG, compute_dtype=torch.float32,
                     adapter_idx=torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    plain, _ = forward(base, torch.from_numpy(ids).long(), CFG, compute_dtype=torch.float32)
    np.testing.assert_array_equal(got[1].numpy(), plain[1].numpy())
    assert (got[0] - plain[0]).abs().max() > 1e-4 and (got[2] - plain[2]).abs().max() > 1e-4


def test_carried_adapter_leaves_forward_as_in_jax(jbase):
    """``params_from_jax`` keeps lora_a / lora_b / lora_scale (f32), and the
    single-adapter forward equals the JAX one."""
    jparams = _bump(jax_lora.add_lora_params(jbase, jax.random.PRNGKey(7), rank=4), 7)
    params = params_from_jax(_flat(jparams), CFG)
    assert params["model.layers.0.self_attn.q_proj.lora_a"].shape == (CFG.hidden_size, 4)
    assert params["model.layers.0.self_attn.q_proj.lora_scale"].dtype == torch.float32
    ids = _ids()
    want, _ = jax_forward(jparams, jnp.asarray(ids), JCFG, compute_dtype=jnp.float32)
    got, _ = forward(params, torch.from_numpy(ids).long(), CFG, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_merge_strip_and_state_dict_equal_jax(jbase):
    jparams = _bump(jax_lora.add_lora_params(jbase, jax.random.PRNGKey(7), rank=4), 7)
    params = params_from_jax(_flat(jparams), CFG)
    merged = lora.merge_lora(params)
    jmerged = _flat(jax_lora.merge_lora(jparams))
    assert list(merged) == [k for k in params if ".lora_" not in k]
    assert set(merged) == set(jmerged)
    for name, t in merged.items():
        np.testing.assert_allclose(t.numpy(), jmerged[name], atol=1e-6, rtol=0, err_msg=name)
    stripped = lora.strip_lora(params)
    assert set(stripped) == set(_flat(jax_lora.strip_lora(jparams)))
    state = lora.lora_state_dict(params)
    jstate = jax_lora.lora_state_dict(jparams)
    assert set(state) == set(jstate)  # (the JAX tree's order is its own)
    for name, t in state.items():
        np.testing.assert_array_equal(t.numpy(), jstate[name])
    # the merged forward equals the adapted one, and differs from the base
    ids = torch.from_numpy(_ids()).long()
    adapted, _ = forward(params, ids, CFG, compute_dtype=torch.float32)
    out, _ = forward(merged, ids, CFG, compute_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), adapted.numpy(), atol=1e-4)
    plain, _ = forward(stripped, ids, CFG, compute_dtype=torch.float32)
    assert (out - plain).abs().max() > 1e-4


def test_peft_adapter_state_equals_jax(jbase, base, adapter_dir):
    for name in ("t1", "t3"):
        path = os.path.join(adapter_dir, name)
        entries, scale, acfg = lora.peft_adapter_state(base, path)
        jentries, jscale, jacfg = jax_lora.peft_adapter_state(jbase, path)
        assert acfg == jacfg and scale == float(jscale)
        assert set(entries) == {".".join(k) for k in jentries}
        for key, (a, b) in jentries.items():
            pa, pb = entries[".".join(key)]
            np.testing.assert_array_equal(pa.numpy(), a)
            np.testing.assert_array_equal(pb.numpy(), b)


def test_peft_round_trip_between_packages(jbase, base, tmp_path):
    """A directory the port writes loads in the JAX package (and back) with
    the same leaves; the scale comes from adapter_config.json (alpha 8 / r 4)."""
    jparams = _bump(jax_lora.add_lora_params(jbase, jax.random.PRNGKey(7), rank=4), 7)
    params = params_from_jax(_flat(jparams), CFG)
    lora.save_lora_adapter(params, str(tmp_path / "port"),
                           lora.LoraConfig(lora_rank=4, lora_alpha=8.0))
    with open(tmp_path / "port" / "adapter_config.json") as f:
        written = json.load(f)
    jax_lora.save_lora_adapter(jparams, str(tmp_path / "jax"),
                               TrainConfig(freeze_strategy="lora", lora_rank=4, lora_alpha=8.0))
    with open(tmp_path / "jax" / "adapter_config.json") as f:
        assert written == json.load(f)
    restored_jax = _flat(jax_lora.load_lora_adapter(jbase, str(tmp_path / "port")))
    restored = lora.load_lora_adapter(base, str(tmp_path / "jax"))
    assert set(restored) == set(params)
    for name, t in restored.items():
        np.testing.assert_array_equal(t.numpy(), restored_jax[name], err_msg=name)
    assert float(restored["model.layers.0.self_attn.q_proj.lora_scale"]) == 2.0
    with pytest.raises(ValueError, match="params carry no LoRA adapters"):
        lora.save_lora_adapter(base, str(tmp_path / "empty"))


def _valid_acfg(rank=4):
    return {"r": rank, "lora_alpha": 8.0, "target_modules": ["q_proj", "v_proj"]}


@pytest.mark.parametrize("bad", [
    {"r": 0}, {"r": "four"}, {"r": True}, {"lora_alpha": -1}, {"lora_alpha": None},
    {"target_modules": []}, {"target_modules": "q_proj"}, {"target_modules": ["made_up_proj"]},
], ids=["r0", "r_str", "r_bool", "alpha_neg", "alpha_none", "targets_empty", "targets_str",
        "targets_unknown"])
def test_validate_config_messages_equal_jax(jbase, base, bad):
    acfg = {**_valid_acfg(), **bad}
    with pytest.raises(ValueError) as want:
        jax_lora.validate_adapter_config(acfg, jbase, "/some/dir")
    with pytest.raises(ValueError) as got:
        lora.validate_adapter_config(acfg, base, "/some/dir")
    assert str(got.value) == str(want.value)
    lora.validate_adapter_config(_valid_acfg(), base)  # a valid one passes


def _refusal(fn_port, fn_jax):
    with pytest.raises(ValueError) as want:
        fn_jax()
    with pytest.raises(ValueError) as got:
        fn_port()
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_tensor_refusals_equal_jax(jbase, base, adapter_dir, tmp_path):
    """A config whose 'r' disagrees with the tensors, tensors of another
    model's width, tensor names that match nothing, and a bare directory."""
    bad_r = tmp_path / "bad_r"
    shutil.copytree(os.path.join(adapter_dir, "t1"), bad_r)
    acfg = json.loads((bad_r / "adapter_config.json").read_text())
    acfg["r"] = 8  # the tensors are rank 4
    (bad_r / "adapter_config.json").write_text(json.dumps(acfg))
    msg = _refusal(lambda: lora.load_lora_adapter(base, str(bad_r)),
                   lambda: jax_lora.load_lora_adapter(jbase, str(bad_r)))
    assert "'r'" in msg

    wide = jax_init_params(jax.random.PRNGKey(0),
                           dataclasses.replace(JCFG, hidden_size=96, intermediate_size=160),
                           dtype=jnp.float32)
    _jax_adapter(wide, str(tmp_path / "wide"), 5)
    msg = _refusal(lambda: lora.peft_adapter_state(base, str(tmp_path / "wide")),
                   lambda: jax_lora.peft_adapter_state(jbase, str(tmp_path / "wide")))
    assert "does not fit the model" in msg

    nothing = tmp_path / "nothing"
    shutil.copytree(os.path.join(adapter_dir, "t1"), nothing)
    state = read_safetensors(str(nothing / "adapter_model.safetensors"))
    write_safetensors(str(nothing / "adapter_model.safetensors"),
                           {k.replace("base_model.model.", "other."): v for k, v in state.items()})
    msg = _refusal(lambda: lora.peft_adapter_state(base, str(nothing)),
                   lambda: jax_lora.peft_adapter_state(jbase, str(nothing)))
    assert "matched no module" in msg

    bare = tmp_path / "bare"
    shutil.copytree(os.path.join(adapter_dir, "t1"), bare)
    os.remove(bare / "adapter_config.json")
    _refusal(lambda: lora.peft_adapter_state(base, str(bare)),
             lambda: jax_lora.peft_adapter_state(jbase, str(bare)))
    entries, scale, acfg = lora.peft_adapter_state(
        base, str(bare), lora.LoraConfig(lora_rank=4, lora_alpha=8.0))
    assert acfg is None and scale == 2.0 and len(entries) == CFG.num_layers * 7


def test_int8_weights_refuse_the_adapter_pool_as_in_jax(jbase, base, adapter_dir):
    """``--quantize int8 --adapter-dir``: both registries find no plain
    kernel to pool beside and refuse with the same message."""
    quantized = maybe_quantize(dict(base), "int8")
    _refusal(lambda: AdapterRegistry(quantized, adapter_dir),
             lambda: JaxRegistry(jax_quantize_int8(jbase), adapter_dir))
