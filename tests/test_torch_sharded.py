"""The port's bucket-sharded engine (sshash_tpu_torch.parallel) against the
JAX package's ShardedEngine on the virtual 8-device CPU mesh
(tests/conftest.py), against the port's oracle and unsharded engine, and
against the host _Batcher. Shards run on a CPU LocalMesh, so every kernel
call takes its plain version. Outputs are integers: tolerance 0."""

import jax
import numpy as np
import pytest
import torch
from sshash_tpu.parallel import ShardedEngine as JaxShardedEngine
from sshash_tpu.parallel import make_mesh

from sshash_tpu_torch import TorchEngine, oracle, synthetic
from sshash_tpu_torch import kmer as K
from sshash_tpu_torch import streaming as ST
from sshash_tpu_torch.layout import device_arrays
from sshash_tpu_torch.parallel import LocalMesh, ShardedEngine, ShardedStream, shard_tables
from test_torch_host import jax_index
from one_thread import one_torch_thread  # noqa: F401

INVALID = np.uint64(2 ** 64 - 1)
BASE = (1 << 31) + 12345  # synthetic.rebase_ids: every found id lands at or above 2^31


def jax_mesh(shape):
    return make_mesh(shape, devices=jax.devices()[: shape[0] * shape[1]])


def mixed_batch(idx, rng, n=512):
    """n positives (the first half reverse-complemented) then n/4 random
    kmers, as tests/test_sharded.py mixes them; an odd length, so the batch
    pads to the data axis."""
    km = oracle.access(idx, rng.integers(0, idx.num_kmers, n))
    km[: n // 2] = K.revcomp_kmers(km[: n // 2], idx.k)
    return np.concatenate([km, synthetic.random_kmers(idx.k, rng, n // 4 + 1)])


def small(name):
    if name == "legacy_m3_skew":
        return synthetic.legacy_skew(synthetic.small_index("m3_skew"))
    return synthetic.small_index(name)


@pytest.mark.parametrize("nb", [2, 4])
@pytest.mark.parametrize("name", ["m13_regular", "m3_skew", "legacy_m3_skew", "short_strings",
                                  "weighted", "k65", "k129_canonical"])
def test_shard_tables_equal_jax(name, nb):
    """Every bucket shard's tables are the JAX ShardedEngine's shard on the
    same mesh, array for array, and per_device_bytes agree but for JAX's
    heavy_rows and sk_positions, which the port does not ship (every heavy
    lane reads sk_hrows). The legacy index's shards are those of the index
    it came from (its hindex derived again: JAX shards it on its own legacy
    path)."""
    idx = small(name)
    jidx = jax_index(synthetic.small_index("m3_skew") if name == "legacy_m3_skew" else idx)
    jeng = JaxShardedEngine(jidx, jax_mesh((1, nb)))
    eng = ShardedEngine(idx, LocalMesh((1, nb), "cpu"))
    shards, geo = shard_tables(device_arrays(idx), eng.cfg, nb)
    assert (geo["per_shard"], geo["per_shard_hrows"], geo["per_shard_swords"],
            geo["per_shard_blocks"]) == (jeng.per_shard, jeng.per_shard_hrows,
                                        jeng.per_shard_swords, jeng.per_shard_blocks)
    assert set(shards[0]) <= set(jeng.arrs)
    devices = jeng.mesh.devices
    for j, tables in enumerate(shards):
        for key, v in tables.items():
            want = next(np.asarray(s.data) for s in jeng.arrs[key].addressable_shards
                        if s.device == devices[0, j])
            assert v.dtype == want.dtype and np.array_equal(v, want), (j, key)
    legacy = sum(s.data.nbytes for key in ("heavy_rows", "sk_positions") if key in jeng.arrs
                 for s in jeng.arrs[key].addressable_shards if s.device == devices[0, 0])
    assert eng.per_device_bytes() == jeng.per_device_bytes() - legacy
    assert eng.handoff == (name in ("m3_skew", "legacy_m3_skew", "k129_canonical"))


def test_lookup_equals_jax():
    """m13_regular on a (4, 2) mesh: every field and the report, positives
    and negatives mixed (the other shapes and configurations:
    tests/test_torch_sharded_lookup.py)."""
    assert_lookup_equals_jax("m13_regular", (4, 2))


def assert_lookup_equals_jax(name, shape):
    idx = synthetic.small_index(name)
    q = mixed_batch(idx, np.random.default_rng(1))
    want, want_rep = JaxShardedEngine(jax_index(idx), jax_mesh(shape)).lookup(q)
    got, rep = ShardedEngine(idx, LocalMesh(shape, "cpu")).lookup(q)
    assert set(got) == set(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    assert rep == want_rep


@pytest.mark.parametrize("name", sorted(synthetic.SMALL_CONFIGS))
def test_lookup_equals_oracle(name):
    """Every small configuration on a (1, 4) mesh: each field equals the
    oracle's; is_member agrees."""
    idx = synthetic.small_index(name)
    q, _ = synthetic.query_batch(idx)
    eng = ShardedEngine(idx, LocalMesh((1, 4), "cpu"))
    got, rep = eng.lookup(q)
    want = oracle.lookup(idx, q)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    assert rep == {"num_kmers": len(q), "num_positive": int((want["kmer_id"] != INVALID).sum())}
    assert np.array_equal(eng.is_member(q), want["kmer_id"] != INVALID)


@pytest.mark.parametrize("name,shape", [("m13_regular", (4, 2)), ("short_strings", (2, 4)),
                                        ("weighted", (2, 4))])
def test_access_and_weight_equal_jax(name, shape):
    """Access in the windowed form (m13_regular) and the two-round form
    with its haloed strings (short_strings); weight by run owner
    (weighted). Every id of the index, an odd count."""
    idx = synthetic.small_index(name)
    jeng = JaxShardedEngine(jax_index(idx), jax_mesh(shape))
    eng = ShardedEngine(idx, LocalMesh(shape, "cpu"))
    ids = np.arange(idx.num_kmers - 1)
    got = eng.access(ids)
    assert np.array_equal(got, jeng.access(ids))
    assert np.array_equal(got, oracle.access(idx, ids))
    if idx.weights is not None:
        w = eng.weight(ids)
        assert np.array_equal(w, jeng.weight(ids))
        assert np.array_equal(w, idx.weights.weight(ids))


def test_navigation_equals_jax():
    idx = synthetic.small_index("m13_canonical")
    q = mixed_batch(idx, np.random.default_rng(2), n=64)
    want = JaxShardedEngine(jax_index(idx), jax_mesh((2, 2))).kmer_neighbours(q)
    got = ShardedEngine(idx, LocalMesh((2, 2), "cpu")).kmer_neighbours(q)
    ref = TorchEngine(idx, "cpu").kmer_neighbours(q)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key
        assert np.array_equal(got[key], ref[key]), key


def straddling_reads(idx, rng, D=4, per=128, read_len=96):
    """Per-position kmers of reads of read_len (not dividing per), so reads
    straddle the data rows, with some random kmers and invalid lanes."""
    B = D * per
    ids, first, pos = [], np.zeros(B, dtype=bool), 0
    while pos < B:
        n = min(read_len, B - pos)
        start = int(rng.integers(0, idx.num_kmers - n))
        ids.extend(range(start, start + n))
        first[pos] = True
        pos += n
    km = oracle.access(idx, np.asarray(ids))
    noise = rng.random(B) < 0.05
    km[noise] = synthetic.random_kmers(idx.k, rng, int(noise.sum()))
    return km, rng.random(B) > 0.02, first


def test_stream_report_equals_jax_and_derive_report():
    idx = synthetic.small_index("m13_regular")
    km, valid, first = straddling_reads(idx, np.random.default_rng(3))
    res = oracle.lookup(idx, km)
    want = ST.derive_report(res["kmer_id"] != INVALID, res["string_id"], res["kmer_id"],
                            res["kmer_orientation"], valid, first)
    jrep = JaxShardedEngine(jax_index(idx), jax_mesh((4, 2))).stream_report(km, valid, first)
    got = ShardedEngine(idx, LocalMesh((4, 2), "cpu")).stream_report(km, valid, first)
    assert got == want
    assert got == {key: jrep[key] for key in got}
    assert want["num_extensions"] > 0 and want["num_invalid_kmers"] > 0


@pytest.mark.parametrize("name", ["m13_canonical", "m3_skew"])
def test_packed_stream_equals_batcher(name, tmp_path):
    """ShardedStream with chunks of 2^11 positions: a genome record split
    into exact-P segments whose chunks land on different data rows, and
    reads with RC, substitutions and Ns; reports equal the host
    _Batcher's."""
    idx = synthetic.small_index(name)
    rng = np.random.default_rng(4)
    strings = synthetic.index_strings(idx)
    genome, fq = str(tmp_path / "genome.fa"), str(tmp_path / "reads.fq")
    synthetic.write_genome(genome, strings, rng)
    reads = synthetic.cut_reads(strings, 200, 90, rng, rc=0.5, subst=0.01)
    synthetic.write_reads(fq, synthetic.with_n(reads + synthetic.random_reads(100, 76, rng),
                                               0.05, rng))
    eng = ShardedEngine(idx, LocalMesh((3, 2), "cpu"))
    for path, ml in ((genome, True), (fq, False)):
        s = ShardedStream(eng, pmax=1 << 11, rmax_shift=10 if ml else 4)
        for seq in ST.parse_reads(path, multiline=ml):
            s.add_read(seq)
        rep = s.finalize()
        assert s.chunks >= 3
        assert rep == ST.host_report(idx, path, multiline=ml)


@pytest.mark.parametrize("name", ["m13_regular", "m3_skew"])
def test_ids_above_2_31_survive_the_combines(name):
    """A sharded v2 engine whose shards' kid0 is rebased by 2^31 + 12345:
    every found id comes back as the unsharded v1 id + that base, every
    miss as 0xFFFFFFFF (the combines order ids as u32)."""
    idx = synthetic.small_index(name)
    q = mixed_batch(idx, np.random.default_rng(5))
    ref = TorchEngine(idx, "cpu").lookup(q)
    eng = ShardedEngine(idx, LocalMesh((2, 4), "cpu"), row_format="v2")
    for j, tables in eng.tables.items():
        eng.tables[j] = synthetic.rebase_ids(eng.cfg, tables, BASE)
    got, _ = eng.lookup(q)
    found = ref["kmer_id"] != INVALID
    assert found.sum() > 0 and (~found).sum() > 0
    want = np.where(found, (ref["kmer_id"] + np.uint64(BASE)) & np.uint64(0xFFFFFFFF), INVALID)
    assert np.array_equal(got["kmer_id"], want)
    assert (got["kmer_id"][found] >= np.uint64(1 << 31)).all()


def test_mesh_combines_order_as_unsigned():
    """u32 bits in int32: 0xFFFFFFFF (-1) is the largest value and 2^31
    the middle one, over either axis."""
    mesh = LocalMesh((2, 3), "cpu")
    vals = np.array([[5, 0xFFFFFFFF, 1 << 31], [0x7FFFFFFF, 3, 0x80000001]], dtype=np.uint32)
    values = {(i, j): torch.tensor([int(np.int32(vals[i, j].view(np.int32)))])
              for i in range(2) for j in range(3)}
    u32 = lambda t: int(t[0]) & 0xFFFFFFFF  # noqa: E731
    for (i, j), t in mesh.pmin(values, "bucket", unsigned=True).items():
        assert u32(t) == int(vals[i].min())
    for (i, j), t in mesh.pmax(values, "bucket", unsigned=True).items():
        assert u32(t) == int(vals[i].max())
    for (i, j), t in mesh.pmin(values, "data", unsigned=True).items():
        assert u32(t) == int(vals[:, j].min())
    assert int(mesh.psum(values, "data")[(1, 0)][0]) == 5 + 0x7FFFFFFF
    moved = mesh.ppermute(values)
    assert int(moved[(0, 1)][0]) == 0 and moved[(1, 2)] is values[(0, 2)]


def test_sharded_engine_defaults_to_the_card():
    """Without a mesh the shards live on the card: on a machine without one
    the upload raises, nothing falls back to the CPU."""
    idx = synthetic.small_index("m9_c1")
    if torch.cuda.is_available():
        assert ShardedEngine(idx).device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        ShardedEngine(idx)

