"""Pre-v1.2 skew forms served in the one-hop form: a skew class without
hindex gets it derived on the host (layout.heavy_kmers,
layout.class_hindex), so its heavy lanes read one sk_hrows row as a v1.2
index's do. The derived hindex against the build's own (which
synthetic.legacy_skew drops, re-keyed through the plain class MPHFs
where it rebuilds them); the legacy index's lookup (full fields and
ids), navigation and bucket-sharded lookup against the JAX package's
legacy path (JAX on the CPU) and both oracles; the converted tables
cached through write_tables. Outputs are integers: tolerance 0."""

import numpy as np
import pytest
import torch

from sshash_tpu import Dictionary
from sshash_tpu.engine import DeviceEngine, _device_arrays
from sshash_tpu.parallel import ShardedEngine as JaxShardedEngine
from sshash_tpu_torch import TorchEngine, oracle, synthetic
from sshash_tpu_torch import engine as E
from sshash_tpu_torch import kmer as K
from sshash_tpu_torch import layout as L
from sshash_tpu_torch.parallel import LocalMesh, ShardedEngine
from test_torch_host import jax_index
from test_torch_sharded import jax_mesh
from one_thread import one_torch_thread  # noqa: F401

INVALID = np.uint64(2 ** 64 - 1)
# every configuration of synthetic.SMALL_CONFIGS and WIDE_CONFIGS with
# heavy buckets, and k65, which has none
CONFIGS = ["m3_skew", "m3_skew_canonical", "k65", "k65_canonical", "k129_canonical"]
FORMS = {"no_hindex": False, "plain_mphf": True}
# the configurations whose lookup JAX compiles in seconds on the CPU
JAX_CONFIGS = ["m3_skew", "m3_skew_canonical"]


def heavy_by_oracle(idx):
    """(keys, class) of every kmer whose bucket is heavy, found by walking
    all kmers with the oracle (independent of layout.heavy_kmers): keys
    (n, W) uint32 as the skew classes hash them."""
    km = oracle.access(idx, np.arange(idx.num_kmers))
    status, _, _, pid = oracle._decode_codewords(idx, synthetic.bucket_minimizers(idx, km))
    if idx.canonical:
        rc = K.revcomp_kmers(km, idx.k)
        km = np.where(oracle._kmer_less_mask(rc, km)[:, None], rc, km)
    heavy = status == 2
    return K.kmers_to_u32(km[heavy], idx.k), pid[heavy]


def rekeyed_hindex(idx, lidx):
    """The build's own hindex of each class of idx, moved to lidx's class
    MPHF positions (the same when the class MPHF is the same):
    want[new_slot(x)] = hindex[old_slot(x)] over the oracle's heavy kmers."""
    keys, pid = heavy_by_oracle(idx)
    out = []
    for i, (p, q) in enumerate(zip(idx.skew_partitions, lidx.skew_partitions)):
        want = np.zeros(p.mphf.n, np.uint32)
        if p.mphf.n:
            sel = keys[pid == i]
            want[q.mphf.eval_words(sel)] = p.hindex[p.mphf.eval_words(sel)]
        out.append(want)
    return out


@pytest.fixture(scope="module", params=CONFIGS)
def built(request):
    return request.param, synthetic.small_index(request.param)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_derived_hindex_equals_the_builds(built, form):
    """class_hindex of the legacy form equals the build's own hindex class
    by class (re-keyed through the plain class MPHFs in that form), and
    the tables it makes equal the v1.2 form's but for the skew classes'
    own MPHF tables."""
    name, idx = built
    lidx = synthetic.legacy_skew(idx, plain_mphf=FORMS[form])
    assert all(p.hindex is None for p in lidx.skew_partitions)
    got = L.class_hindex(lidx)
    want = rekeyed_hindex(idx, lidx)
    assert len(got) == len(want) == len(idx.skew_partitions[:L.NUM_SKEW])
    for i, (g, w, p) in enumerate(zip(got, want, idx.skew_partitions)):
        assert g.dtype == np.uint32 and np.array_equal(g, w), f"{name} class {i}"
        if not FORMS[form]:
            assert np.array_equal(g, p.hindex), f"{name} class {i}"
    port, v12 = L.device_arrays(lidx), L.device_arrays(idx)
    assert not set(L.LEGACY_KEYS) & set(port)
    skew_mphf = {"sk_pilots", "sk_seedrows"} | {f"sk_{p}" for p in L.SKEW_PARAMS}
    for key, v in v12.items():
        if not (FORMS[form] and key in skew_mphf | {"sk_hrows"}):
            assert np.array_equal(port[key], v), f"{name}: {key}"
    assert (sum(p.mphf.n for p in idx.skew_partitions) > 0) == (name != "k65")


def test_heavy_kmers_are_the_heavy_buckets(built):
    """heavy_kmers, walking the heavy buckets' positions only, finds every
    kmer whose bucket is heavy, once, in its own class and bucket, and no
    kmer of another bucket."""
    name, idx = built
    keys, cls, begin, off = L.heavy_kmers(idx, chunk=7)
    want_keys, want_cls = heavy_by_oracle(idx)
    assert len(np.unique(off)) == len(off)
    W = keys.shape[1]
    as_rows = lambda k, c: {tuple(r) + (int(x),) for r, x in zip(k.tolist(), c)}  # noqa: E731
    assert as_rows(keys, cls) == as_rows(want_keys, want_cls)
    # each offset's kmer is the key given (its canonical strand) in the
    # bucket given
    km = K.read_kmers_at(idx.strings64, off, idx.k)
    status, bbeg, _, pid = oracle._decode_codewords(idx, synthetic.bucket_minimizers(idx, km))
    assert (status == 2).all() and np.array_equal(bbeg, begin) and np.array_equal(pid, cls)
    if idx.canonical:
        rc = K.revcomp_kmers(km, idx.k)
        km = np.where(oracle._kmer_less_mask(rc, km)[:, None], rc, km)
    assert np.array_equal(K.kmers_to_u32(km, idx.k).reshape(-1, W), keys)


def heavy_misses(idx, rng, n):
    """Up to n kmers absent from the index whose bucket is heavy: heavy
    kmers with one char changed away from their minimizer (the first or
    the last char), kept where the bucket stays heavy and the kmer is not
    found."""
    keys, _ = heavy_by_oracle(idx)
    if not len(keys):
        return np.zeros((0, K.num_words64(idx.k)), np.uint64)
    km = K.u32_to_kmers64(keys[rng.choice(len(keys), min(4 * n, len(keys)), replace=False)],
                          idx.k)
    words = km.copy()
    last = (idx.k - 1) // 32, 2 * ((idx.k - 1) % 32)
    words[::2, 0] ^= np.uint64(1)  # the first char
    words[1::2, last[0]] ^= np.uint64(1) << np.uint64(last[1])  # the last char
    status = oracle._decode_codewords(idx, synthetic.bucket_minimizers(idx, words))[0]
    missed = oracle.lookup(idx, words)["kmer_id"] == INVALID
    return words[(status == 2) & missed][:n]


def legacy_batch(idx, seed):
    """query_batch's mix (positives, heavy and sweep positives, random
    negatives) with heavy misses after it, cut to a length that is not a
    multiple of 16; its number of heavy misses."""
    q, _ = synthetic.query_batch(idx, seed)
    miss = heavy_misses(idx, np.random.default_rng(seed), 64)
    q = np.concatenate([q, miss])
    q = q[: len(q) - (len(q) % 16 == 0)]
    assert len(q) % 16
    return q, len(miss)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name", CONFIGS)
def test_legacy_lookup_and_navigation_equal_both_oracles(name, form):
    """Every field of the legacy form's lookup, its id fields and its
    navigation equal the port's oracle, the JAX package's oracle
    (Dictionary) and the v1.2 form's, on a batch with heavy misses."""
    idx = synthetic.small_index(name)
    lidx = synthetic.legacy_skew(idx, plain_mphf=FORMS[form])
    q, nmiss = legacy_batch(idx, 3)
    eng = TorchEngine(lidx, "cpu")
    got = eng.lookup(q)
    want = oracle.lookup(lidx, q)
    jwant = Dictionary(jax_index(lidx)).lookup(q)
    v12 = TorchEngine(idx, "cpu").lookup(q)
    for key in want:
        assert np.array_equal(got[key], want[key]), f"{key} vs oracle"
        assert np.array_equal(got[key], np.asarray(jwant[key])), f"{key} vs JAX's oracle"
        assert np.array_equal(got[key], v12[key]), f"{key} vs v1.2 form"
    if name != "k65":
        assert nmiss > 0 and (got["kmer_id"][-nmiss:] == INVALID).all()
    ids = E._to_host_result(E.lookup(eng.cfg, eng.tables, eng.kmers32(q), None, "ids"))
    for key in ids:
        assert np.array_equal(ids[key], got[key]), f"ids form: {key}"
    nav, nav12 = eng.kmer_neighbours(q[:97]), TorchEngine(idx, "cpu").kmer_neighbours(q[:97])
    ref = Dictionary(jax_index(lidx)).kmer_neighbours(q[:97])
    for key in nav:
        assert np.array_equal(nav[key], nav12[key]), f"navigation {key} vs v1.2 form"
    for side, cols in (("forward", slice(0, 4)), ("backward", slice(4, 8))):
        for key, v in ref[side].items():
            assert np.array_equal(nav[key][:, cols], v), f"navigation {side} {key}"


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name", JAX_CONFIGS)
def test_legacy_lookup_equals_jax_device_engine(name, form):
    """Lookup (every field) and navigation of the legacy form equal the JAX
    DeviceEngine's on the same legacy index, whose heavy lanes take its
    skew_eval (slot -> position in the bucket -> heavy row)."""
    idx = synthetic.legacy_skew(synthetic.small_index(name), plain_mphf=FORMS[form])
    q, _ = legacy_batch(synthetic.small_index(name), 5)
    jeng = DeviceEngine(jax_index(idx))
    assert "sk_positions" in _device_arrays(jax_index(idx))
    eng = TorchEngine(idx, "cpu")
    got, want = eng.lookup(q), jeng.lookup(q)
    assert set(got) == set(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    got, want = eng.kmer_neighbours(q[:101]), jeng.kmer_neighbours(q[:101])
    for key in want:
        assert np.array_equal(got[key], want[key]), f"navigation {key}"


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name", JAX_CONFIGS)
def test_legacy_sharded_equals_jax_and_oracle(name, form, shape):
    """The ShardedEngine on a legacy index (the hand-off, as a v1.2
    index's) equals the JAX ShardedEngine on it (its legacy path, heavy
    rows re-keyed a shard) and the oracle in every field and the report."""
    idx = synthetic.legacy_skew(synthetic.small_index(name), plain_mphf=FORMS[form])
    q, _ = legacy_batch(synthetic.small_index(name), 7)
    eng = ShardedEngine(idx, LocalMesh(shape, "cpu"))
    assert eng.handoff
    got, rep = eng.lookup(q)
    want, want_rep = JaxShardedEngine(jax_index(idx), jax_mesh(shape)).lookup(q)
    ref = oracle.lookup(idx, q)
    assert set(got) == set(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
        assert np.array_equal(got[key], ref[key]), f"{key} vs oracle"
    assert rep == want_rep


@pytest.mark.parametrize("form", sorted(FORMS))
def test_converted_tables_round_trip_write_tables(form, tmp_path):
    """The legacy form's tables written by write_tables (the conversion
    paid once) load as device_arrays' and serve as they do; the JAX
    package's legacy dict converts to them through the index, and without
    it is refused."""
    idx0 = synthetic.small_index("m3_skew_canonical")
    idx = synthetic.legacy_skew(idx0, plain_mphf=FORMS[form])
    loaded = L.write_tables(idx, str(tmp_path / "tables"), chunk=1 << 10, threads=2)
    own = L.device_arrays(idx)
    assert set(loaded) == set(own) and not set(L.LEGACY_KEYS) & set(loaded)
    for key, v in own.items():
        assert np.array_equal(np.asarray(loaded[key]), v), key
    q, _ = legacy_batch(idx0, 9)
    got = TorchEngine(idx, "cpu", host_arrs=L.load_tables(str(tmp_path / "tables"))).lookup(q)
    want = oracle.lookup(idx, q)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    cfg = L.StaticCfg(idx)
    jarrs = _device_arrays(jax_index(idx))
    with pytest.raises(ValueError, match="pass it"):
        L.tables_from_host(jarrs, "cpu", cfg)
    conv, mine = L.tables_from_host(jarrs, "cpu", cfg, idx), L.tables_from_host(own, "cpu", cfg)
    assert set(conv) == set(mine)
    for key in mine:
        assert torch.equal(conv[key], mine[key]), key
