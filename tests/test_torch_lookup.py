"""TorchEngine on the CPU against the JAX DeviceEngine (JAX on the CPU) and
the NumPy oracle, in every lane and every field, on each small
configuration that chip_smoke.py also runs on the card. Each batch holds
50%-RC positives (uniform ids plus kmers of multi-position and heavy
buckets, so every probe path runs), random negatives, and a shuffled mix;
its size is odd. All outputs are integers: the tolerance is 0."""

import numpy as np
import pytest

from sshash_tpu import oracle
from sshash_tpu.engine import DeviceEngine
from sshash_tpu_torch import TorchEngine, kernels, synthetic
from sshash_tpu_torch.engine import _to_host_result, make_lookup, probe_plain
from sshash_tpu_torch.ops import packed as P
from test_torch_host import jax_index
from one_thread import one_torch_thread  # noqa: F401

IDS_KEYS = ("kmer_id", "kmer_orientation", "minimizer_found")


@pytest.fixture(scope="module", params=sorted(synthetic.SMALL_CONFIGS))
def case(request):
    idx = synthetic.small_index(request.param)
    q, npos = synthetic.query_batch(idx)
    return request.param, idx, q, npos, oracle.lookup(idx, q)


def test_lookup_equals_jax_and_oracle(case):
    name, idx, q, npos, want = case
    eng = TorchEngine(idx, "cpu")
    got = eng.lookup(q)
    jax_got = DeviceEngine(jax_index(idx)).lookup(q)
    assert set(got) == set(want) == set(jax_got)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), f"{name}: {key} vs oracle"
        assert np.array_equal(got[key], jax_got[key]), f"{name}: {key} vs jax"
    assert (got["kmer_id"][:npos] != np.uint64(2 ** 64 - 1)).all()
    ids = _to_host_result(eng.lookup_ids_device(eng.kmers32(q)))
    assert set(ids) == set(IDS_KEYS)
    for key in IDS_KEYS:
        assert np.array_equal(ids[key], want[key]), f"{name}: ids {key}"
    assert np.array_equal(eng.is_member(q), want["kmer_id"] != np.uint64(2 ** 64 - 1))


def test_plain_lookup_equals_engine_lookup(case):
    """make_lookup with the plain versions passed in (what chip_smoke.py
    times on the card) is the same lookup."""
    name, idx, q, _, want = case
    eng = TorchEngine(idx, "cpu")
    fn = make_lookup(eng.cfg, "full", minimizer=P.minimizer_plain, probe=probe_plain)
    before = kernels.counts()
    got = _to_host_result(fn(eng.tables, eng.kmers32(q)))
    assert kernels.counts() == before
    for key in want:
        assert np.array_equal(got[key], want[key]), key
