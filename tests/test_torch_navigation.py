"""Navigation on the CPU: the neighbour variants against the JAX package's
ops/packed.py, and TorchEngine.kmer_neighbours against the JAX
DeviceEngine (JAX on the CPU, keys, values and dtypes) and the oracle's
Dictionary.kmer_neighbours, on every small configuration that
chip_smoke.py also runs on the card. All outputs are integers: the
tolerance is 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sshash_tpu import Dictionary, oracle
from sshash_tpu import kmer as K
from sshash_tpu.engine import DeviceEngine
from sshash_tpu.ops import packed as JP
from sshash_tpu_torch import TorchEngine, kernels, synthetic
from sshash_tpu_torch.engine import make_neighbours, probe_plain
from sshash_tpu_torch.ops import packed as P
from test_torch_host import jax_index
from one_thread import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("k", [15, 16, 31, 47, 63, 64, 65, 127, 129, 255])
def test_variants_match_jax_ops(k):
    rng = np.random.default_rng(k)
    k32 = K.kmers_to_u32(synthetic.random_kmers(k, rng, 513), k)
    jk = jnp.asarray(k32)
    fwd, bwd = JP.drop_one_char(jk), JP.shift_up_one_char(jk, k)
    want = np.stack([np.asarray(JP.set_char(fwd, k - 1, c)) for c in range(4)]
                    + [np.asarray(JP.set_char(bwd, 0, c)) for c in range(4)])
    before = kernels.counts()
    got = P.neighbour_variants(torch.from_numpy(k32.view(np.int32)), k)
    assert kernels.counts() == before
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, 513, k32.shape[1])
    assert np.array_equal(got.numpy().view(np.uint32), want)
    with pytest.raises(ValueError, match="neighbours"):
        P.neighbour_variants(torch.empty((4, k32.shape[1]), dtype=torch.int32,
                                         device="meta"), k)


def query(idx, rng):
    """Kmers of the index, a third of them reverse-complemented (inside a
    string, a kmer's forward neighbour is the string's next kmer), and
    random kmers."""
    ids = rng.integers(0, idx.num_kmers, 40)
    km = oracle.access(idx, ids)
    km[::3] = K.revcomp_kmers(km[::3], idx.k)
    return np.concatenate([km, synthetic.random_kmers(idx.k, rng, 9)])


@pytest.mark.parametrize("name", sorted(synthetic.SMALL_CONFIGS))
def test_neighbours_equal_jax_and_oracle(name):
    idx = synthetic.small_index(name)
    q = query(idx, np.random.default_rng(3))
    eng = TorchEngine(idx, "cpu")
    got = eng.kmer_neighbours(q)
    want = DeviceEngine(jax_index(idx)).kmer_neighbours(q)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == (len(q), 8), key
        assert np.array_equal(got[key], want[key]), f"{name}: {key}"
    assert (got["kmer_id"] != np.uint64(2 ** 64 - 1)).sum() > len(q) // 2
    ref = Dictionary(jax_index(idx)).kmer_neighbours(q)
    for side, cols in (("forward", slice(0, 4)), ("backward", slice(4, 8))):
        for key, v in ref[side].items():
            assert np.array_equal(got[key][:, cols], v), f"{name}: {side} {key}"
    # the same navigation with the plain versions passed in (what
    # chip_smoke.py times on the card)
    plain = make_neighbours(eng.cfg, "ids", variants=P.neighbour_variants_plain,
                            minimizer=P.minimizer_plain, probe=probe_plain)
    res = plain(eng.tables, eng.kmers32(q))
    ids = res["kmer_id"].numpy().view(np.uint32).astype(np.uint64)
    ids[~res["found"].numpy()] = np.uint64(2 ** 64 - 1)
    assert np.array_equal(ids, got["kmer_id"])
