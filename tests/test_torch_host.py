"""The port's own host side against the JAX package's: the builder gives
array-equal indexes on every small configuration, an index saved by one
package loads in the other, and the oracle and the Dictionary facade give
the same answers.

`jax_index` hands a port-built Index to the JAX package through the shared
on-disk format (the two packages' classes are distinct, and the JAX
engine dispatches on its own MPHF classes); the other port test files use
it."""

import dataclasses
import os
import tempfile

import numpy as np
import pytest

import sshash_tpu
from sshash_tpu import oracle as joracle
from sshash_tpu.index import Index as JaxIndex
from sshash_tpu_torch import Dictionary, Index, build, oracle, synthetic
from one_thread import one_torch_thread  # noqa: F401


def _reload(idx, loader, fmt):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "index.npz" if fmt == "npz" else "index")
        idx.save(path)
        # a directory index is memory-mapped; the mappings outlive the files
        return loader(path)


def jax_index(idx):
    """The port's Index as the JAX package's Index (save, then load)."""
    return _reload(idx, JaxIndex.load, "npz")


def assert_same_index(a, b):
    """Every array and every format field equal (build stats aside)."""
    arr_a, meta_a = a._arrays_and_meta()
    arr_b, meta_b = b._arrays_and_meta()
    assert set(arr_a) == set(arr_b)
    for key in arr_a:
        assert arr_a[key].dtype == arr_b[key].dtype, key
        assert np.array_equal(arr_a[key], arr_b[key]), key
    meta_a, meta_b = dict(meta_a), dict(meta_b)
    meta_a.pop("stats"), meta_b.pop("stats")
    assert meta_a == meta_b


@pytest.fixture(scope="module", params=sorted(synthetic.SMALL_CONFIGS))
def both(request):
    """(name, port-built Index, JAX-built Index) from one FASTA."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "unitigs.fa")
        cfg = synthetic.write_input(path, **synthetic.SMALL_CONFIGS[request.param])
        jcfg = sshash_tpu.BuildConfig(**dataclasses.asdict(cfg))
        return request.param, build(path, cfg), sshash_tpu.Dictionary.build(path, jcfg).index


def test_build_equals_jax(both):
    name, idx, jidx = both
    assert isinstance(idx, Index)
    assert_same_index(idx, jidx)
    assert idx.num_kmers == jidx.num_kmers and idx.stats["num_kmers"] == jidx.stats["num_kmers"]


def test_oracle_and_dictionary_equal_jax(both):
    """lookup, access and kmer_neighbours of the port's oracle and
    Dictionary equal the JAX package's on query_batch."""
    name, idx, jidx = both
    q, npos = synthetic.query_batch(idx)
    got, want = oracle.lookup(idx, q), joracle.lookup(jidx, q)
    assert set(got) == set(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    assert (got["kmer_id"][:npos] != np.uint64(2 ** 64 - 1)).all()
    ids = np.arange(idx.num_kmers)
    assert np.array_equal(oracle.access(idx, ids), joracle.access(jidx, ids))
    d, jd = Dictionary(idx), sshash_tpu.Dictionary(jidx)
    nb, jnb = d.kmer_neighbours(q[:300]), jd.kmer_neighbours(q[:300])
    for side in ("forward", "backward"):
        for key in jnb[side]:
            assert np.array_equal(nb[side][key], jnb[side][key]), (side, key)
    if idx.weights is not None:
        assert np.array_equal(d.weight(ids), jd.weight(ids))


@pytest.mark.parametrize("fmt", ["npz", "dir"])
@pytest.mark.parametrize("name", ["partitioned", "m3_skew_canonical", "weighted"])
def test_saved_index_loads_in_the_other_package(name, fmt):
    idx = synthetic.small_index(name)
    to_jax = _reload(idx, JaxIndex.load, fmt)
    assert_same_index(idx, to_jax)
    back = _reload(to_jax, Index.load, fmt)
    assert isinstance(back, Index)
    assert_same_index(idx, back)
    q, _ = synthetic.query_batch(idx)
    assert np.array_equal(oracle.lookup(back, q)["kmer_id"], joracle.lookup(to_jax, q)["kmer_id"])


def test_dictionary_build_load_save(tmp_path):
    path = str(tmp_path / "unitigs.fa")
    cfg = synthetic.write_input(path, **synthetic.SMALL_CONFIGS["k15"])
    d = Dictionary.build(path, cfg)
    d.save(str(tmp_path / "d.npz"))
    d2 = Dictionary.load(str(tmp_path / "d.npz"))
    assert_same_index(d.index, d2.index)
    ids = np.arange(0, d.num_kmers(), 5)
    assert np.array_equal(d2.lookup(d.access(ids))["kmer_id"], ids.astype(np.uint64))
    eng = d2.to_device("cpu")
    assert eng is d2.to_device("cpu") and eng.device.type == "cpu"
    assert np.array_equal(eng.access(ids), d.access(ids))
