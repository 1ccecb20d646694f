"""The port's data pipeline against the JAX package's: the JSONL rows equal
the parquet rows, the numpy split equals the HF-backed split, the tokenized
arrays and the loader's batches are bit-equal."""

import os

import numpy as np
import pytest

from llm_fine_tune_distributed_tpu.data import dataset as jax_dataset
from llm_fine_tune_distributed_tpu.data import loader as jax_loader
from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer as JaxTokenizer
from llm_fine_tune_distributed_tpu_torch.data import dataset, loader
from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JSONL = os.path.join(ROOT, "data", "final_qa_data_unique.jsonl")
PARQUET = os.path.join(ROOT, "data", "qa_dataset.parquet")
SHORT_PROMPT = "You are a wilderness survival expert."


@pytest.fixture(scope="module")
def rows():
    return dataset.load_qa_dataset(JSONL)


def test_jsonl_rows_equal_the_parquet_rows(rows):
    assert len(rows) == 2845
    assert rows == jax_dataset.load_qa_dataset(PARQUET)


def test_parquet_path_is_refused_with_the_jsonl_named():
    with pytest.raises(ValueError, match="final_qa_data_unique.jsonl"):
        dataset.load_qa_dataset(PARQUET)


@pytest.mark.parametrize("n", [100, 120, 2845])
def test_split_equals_the_hf_split(rows, n):
    ours = dataset.train_validation_split(rows[:n], test_size=0.1, seed=42)
    ref = jax_dataset.train_validation_split(rows[:n], test_size=0.1, seed=42)
    assert ours[0] == ref[0] and ours[1] == ref[1]


@pytest.mark.parametrize("completion_only", [False, True])
@pytest.mark.parametrize("prompt", [None, SHORT_PROMPT], ids=["default_prompt", "short_prompt"])
def test_sft_arrays_bit_equal(rows, prompt, completion_only):
    kw = {} if prompt is None else {"system_prompt": prompt}
    subset = rows[:300]
    ours = dataset.build_sft_arrays(subset, ByteChatMLTokenizer(), 1024, completion_only, **kw)
    ref = jax_dataset.build_sft_arrays(subset, JaxTokenizer(), 1024, completion_only, **kw)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    if prompt is None:  # the 1378-byte prompt fills every 1024-token row
        assert int(ours["lengths"].min()) == 1024
    else:
        assert int(ours["lengths"].max()) < 1024


def test_loader_batches_equal_over_two_epochs(rows):
    arrays = dataset.build_sft_arrays(rows[:108], ByteChatMLTokenizer(), 256,
                                      system_prompt=SHORT_PROMPT)
    ours = loader.SFTBatchLoader(arrays, per_device_batch_size=8, grad_accum_steps=4, seed=42)
    ref = jax_loader.SFTBatchLoader(arrays, per_device_batch_size=8, grad_accum_steps=4, seed=42)
    assert ours.steps_per_epoch == ref.steps_per_epoch == 3
    for epoch in range(2):
        got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.keys() == b.keys() and "lengths" not in a
            for k in a:
                assert a[k].shape == (4, 8, 256)
                np.testing.assert_array_equal(a[k], b[k])
