"""Access, iteration and weight on the CPU: TorchEngine against the JAX
DeviceEngine (JAX on the CPU) and the NumPy oracle, on every small
configuration that chip_smoke.py also runs on the card. All outputs are
integers: the tolerance is 0."""

import numpy as np
import pytest
import torch

from sshash_tpu import oracle
from sshash_tpu import kmer as K
from sshash_tpu.engine import DeviceEngine, make_iterator
from sshash_tpu_torch import TorchEngine, kernels, synthetic
from sshash_tpu_torch import engine as E
from sshash_tpu_torch.layout import acc_windowed
from test_torch_host import jax_index
from one_thread import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", params=sorted(synthetic.SMALL_CONFIGS))
def case(request):
    idx = synthetic.small_index(request.param)
    return request.param, idx, TorchEngine(idx, "cpu"), DeviceEngine(jax_index(idx))


def edge_ids(idx, rng):
    """0 and num_kmers-1, every string's first and last kmer, both sides of
    every 32-id block edge, and random ids."""
    n, k = idx.num_kmers, idx.k
    ep = idx.string_endpoints.astype(np.int64)
    cum = ep - np.arange(len(ep)) * (k - 1)
    blk = np.arange(32, n, 32)
    ids = np.concatenate([[0, n - 1], cum[:-1], cum[1:] - 1, blk - 1, blk,
                          rng.integers(0, n, 999)])
    return ids.astype(np.uint32)


def test_access_equals_jax_and_oracle(case):
    name, idx, eng, jeng = case
    ids = edge_ids(idx, np.random.default_rng(1))
    got = eng.access(ids)
    assert got.dtype == np.uint64
    assert np.array_equal(got, oracle.access(idx, ids)), name
    assert np.array_equal(got, jeng.access(ids)), name
    # past num_kmers: the windowed form reads what JAX reads; the two-round
    # form only reads in bounds
    beyond = np.array([idx.num_kmers, idx.num_kmers + 33, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                      dtype=np.uint32)
    got = eng.access(beyond)
    assert got.shape == (len(beyond), K.num_words64(idx.k))
    if acc_windowed(idx.k, eng.cfg.access_C):
        assert np.array_equal(got, jeng.access(beyond)), name


def test_short_strings_take_the_two_round_form():
    idx = synthetic.small_index("short_strings")
    eng = TorchEngine(idx, "cpu")
    assert eng.cfg.access_C == DeviceEngine(jax_index(idx)).cfg.access_C > 1
    assert not acc_windowed(idx.k, eng.cfg.access_C)
    assert eng.tables["acc_rows"].shape[1] == 1 + eng.cfg.access_C
    ids = np.arange(idx.num_kmers)
    assert np.array_equal(eng.access(ids), oracle.access(idx, ids))


def test_iterator_equals_jax(case):
    name, idx, eng, jeng = case
    before = kernels.counts()
    count, checksum = eng.iterator()
    assert kernels.counts() == before  # CPU tensors never reach a kernel
    jcount, jchecksum = jeng._iterator(jeng.arrs)
    assert count.dtype == checksum.dtype == np.uint32
    assert (count, checksum) == (np.uint32(jcount), np.uint32(jchecksum)), name
    assert count == idx.num_kmers
    # the checksum from the oracle's kmers, in id order
    words = K.kmers_to_u32(oracle.access(idx, np.arange(idx.num_kmers)), idx.k)
    fold = np.bitwise_xor.reduce(words, axis=1).astype(np.uint64)
    assert checksum == np.uint32(int(fold.sum()) & 0xFFFFFFFF)


def test_materialized_iteration_equals_jax_and_oracle(case):
    name, idx, eng, jeng = case
    valid, kmers = E.iterate_kmers_plain(idx.k, eng.tables["strings32"], eng.tables["vstart32"])
    jvalid, jkmers = make_iterator(jeng.cfg, materialize=True)(jeng.arrs)
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    assert np.array_equal(kmers.numpy().view(np.uint32), np.asarray(jkmers))
    want = K.kmers_to_u32(oracle.access(idx, np.arange(idx.num_kmers)), idx.k)
    assert np.array_equal(kmers[valid].numpy().view(np.uint32), want), name


def test_weight_equals_jax_and_index():
    idx = synthetic.small_index("weighted")
    eng, jeng = TorchEngine(idx, "cpu"), DeviceEngine(jax_index(idx))
    rng = np.random.default_rng(2)
    ep = idx.weights.interval_endpoints.astype(np.int64)
    ids = np.concatenate([edge_ids(idx, rng), ep[1:-1] - 1, ep[1:-1]]).astype(np.uint32)
    got = eng.weight(ids)
    assert got.dtype == np.uint64
    assert np.array_equal(got, idx.weights.weight(ids))
    assert np.array_equal(got, jeng.weight(ids))
    assert len(np.unique(got)) > 4 and got.max() > 100  # runs and skew are there
    beyond = np.array([idx.num_kmers, 2 ** 31, 2 ** 32 - 1], dtype=np.uint32)
    assert np.array_equal(eng.weight(beyond), jeng.weight(beyond))


def test_weight_on_unweighted_index_raises():
    eng = TorchEngine(synthetic.small_index("m9_c1"), "cpu")
    assert "w_dictionary" not in eng.tables and eng.table_bytes()["weight"] == 0
    with pytest.raises(RuntimeError, match="not weighted"):
        eng.weight([0, 1])
    with pytest.raises(RuntimeError, match="not weighted"):
        eng.weight_device(torch.zeros(2, dtype=torch.int32))


def test_entry_points_take_cpu_and_cuda_only():
    eng = TorchEngine(synthetic.small_index("weighted"), "cpu")
    meta = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="access"):
        E.access(eng.cfg, eng.tables, meta)
    with pytest.raises(ValueError, match="weight"):
        E.weight(eng.tables, meta)
    with pytest.raises(ValueError, match="iterator"):
        E.iterate(eng.cfg.k, meta, meta)
