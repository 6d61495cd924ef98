"""k > 63 (five or more u32 words per kmer) through the port, on the CPU,
against the JAX package: the table layout, lookup (full and ids fields,
including canonical tie lanes that hit and that miss), membership, access
in both row forms, iteration, weight, navigation, streaming and the
LocalMesh sharded lookup, each equal to sshash_tpu.engine.DeviceEngine
(or its stream) and to both oracles. Tolerance 0: every output is an
integer.

The checks are functions of a configuration name of
synthetic.WIDE_CONFIGS. This file runs them on the two k65
configurations; tests/test_torch_wide_k127.py and test_torch_wide_k129.py
run them on the W = 8 and W = 9 ones, in files of their own because the
JAX package compiles each of its programs for minutes at those widths
(its lookup about 1 and 2.4 minutes on this CPU; its navigation, 8
lookups in one program, longer than 5 at W = 9). There navigation and
streaming are held to both oracles and the JAX host stream, and the
lookup to JAX's DeviceEngine as well. Each configuration's JAX lookup is
computed once per process (one compile)."""

import dataclasses
import functools
import os
import tempfile

import numpy as np
import pytest
import torch

import sshash_tpu
from sshash_tpu import oracle as joracle
from sshash_tpu import streaming as JS
from sshash_tpu.engine import DeviceEngine, _device_arrays
from sshash_tpu.engine import StaticCfg as JaxCfg
from sshash_tpu_torch import Dictionary, TorchEngine, oracle, synthetic
from sshash_tpu_torch import engine as E
from sshash_tpu_torch import layout as L
from sshash_tpu_torch import streaming as ST
from sshash_tpu_torch.parallel import LocalMesh, ShardedEngine
from test_torch_host import jax_index
from test_torch_layout import GEOMETRY
from one_thread import one_torch_thread  # noqa: F401 (autouse; test_torch_wide_k1* import it)

INVALID = np.uint64(2 ** 64 - 1)
TIES = 120  # tie lanes that hit, and as many that miss, per canonical configuration


@functools.lru_cache(maxsize=None)
def case(name):
    """(idx, JAX index, port engine on the CPU, JAX DeviceEngine, query
    batch, lanes of tie hits, lanes of tie misses): the batch is
    query_batch's mix, then, on a canonical index, tie_batch's hits and
    misses."""
    idx = synthetic.small_index(name)
    jidx = jax_index(idx)
    q, _ = synthetic.query_batch(idx)
    hits = misses = np.zeros(0, dtype=np.int64)
    if idx.canonical:
        th, tm = synthetic.tie_batch(idx, np.random.default_rng(7), TIES)
        hits = len(q) + np.arange(len(th))
        misses = len(q) + len(th) + np.arange(len(tm))
        q = np.concatenate([q, th, tm])
    return idx, jidx, TorchEngine(idx, "cpu"), DeviceEngine(jidx), q, hits, misses


@functools.lru_cache(maxsize=None)
def jax_lookup(name):
    _, _, _, jeng, q, _, _ = case(name)
    return jeng.lookup(q)


def check_layout(name):
    """Tables array-equal to JAX's _device_arrays, geometry to its StaticCfg
    (W, win_words, max_start_word, the access row form)."""
    idx, jidx = case(name)[:2]
    port, want = L.device_arrays(idx), _device_arrays(jidx)
    for key, v in port.items():
        assert v.dtype == np.uint32 and np.array_equal(v, want[key]), key
    cfg, jcfg = L.StaticCfg(idx), JaxCfg(jidx)
    for attr in GEOMETRY:
        assert getattr(cfg, attr) == getattr(jcfg, attr), attr
    assert cfg.W == (2 * idx.k + 31) // 32 >= 5
    assert L.acc_width(cfg) == want["acc_rows"].shape[1]
    # JAX serves wide canonical kmers with its cond tie retry, not the fold
    assert (jcfg.max_start_word + 1) * jcfg.W > 8


def check_lookup(name):
    """Every field of the full lookup equals JAX's DeviceEngine and both
    oracles; the ids lookup and is_member agree."""
    idx, jidx, eng, _, q, _, _ = case(name)
    got, want = eng.lookup(q), jax_lookup(name)
    assert set(got) == set(want)
    for ref in (want, oracle.lookup(idx, q), joracle.lookup(jidx, q)):
        for key in ref:
            assert np.array_equal(got[key], ref[key]), key
    ids = E._to_host_result(eng.lookup_ids_device(eng.kmers32(q)))
    assert set(ids) == {"kmer_id", "kmer_orientation", "minimizer_found"}
    for key, v in ids.items():
        assert np.array_equal(v, got[key]), key
    member = eng.is_member(q)
    assert np.array_equal(member, got["kmer_id"] != INVALID)
    assert 0 < member.sum() < len(q)


def check_ties(name):
    """Canonical tie lanes (both strands' minimizer values equal), hits and
    misses: the port's fold gives JAX's cond retry's answer in every field,
    minimizer_found included."""
    idx, _, eng, _, q, hits, misses = case(name)
    assert len(hits) >= TIES // 2 and len(misses) >= TIES // 2
    lanes = np.concatenate([hits, misses])
    assert synthetic.tie_kmers(idx, q[lanes]).all()
    got, want = eng.lookup(q), jax_lookup(name)
    assert (got["kmer_id"][hits] != INVALID).all() and (got["kmer_id"][misses] == INVALID).all()
    assert got["minimizer_found"][lanes].all()
    for key in want:
        assert np.array_equal(got[key][lanes], want[key][lanes]), key


def check_access_iteration_weight(name):
    """Access of every id (the configuration's row form) equals JAX's and
    both oracles; iteration's (count, checksum) equals JAX's; a weighted
    index's weights equal JAX's and index.weights."""
    idx, jidx, eng, jeng = case(name)[:4]
    ids = np.arange(idx.num_kmers)
    got = eng.access(ids)
    for ref in (jeng.access(ids), oracle.access(idx, ids), joracle.access(jidx, ids)):
        assert np.array_equal(got, ref)
    count, checksum = eng.iterator()
    jcount, jchecksum = jeng._iterator(jeng.arrs)
    assert (count, checksum) == (int(jcount), int(jchecksum)) and count == idx.num_kmers
    if idx.weights is not None:
        w = eng.weight(ids)
        assert np.array_equal(w, jeng.weight(ids))
        assert np.array_equal(w, idx.weights.weight(ids))
    return L.acc_windowed(idx.k, eng.cfg.access_C)


def check_navigation(name, jax_device=True):
    """The 8 neighbours of 64 kmers (half reverse-complemented) equal both
    oracle Dictionaries' and, with jax_device, JAX's
    DeviceEngine.kmer_neighbours."""
    idx, jidx, eng, jeng, q = case(name)[:5]
    km = q[:64]
    got = eng.kmer_neighbours(km)
    if jax_device:
        want = jeng.kmer_neighbours(km)
        assert set(got) == set(want)
        for key in want:
            assert np.array_equal(got[key], want[key]), key
    for d in (Dictionary(idx), sshash_tpu.Dictionary(jidx)):
        ref = d.kmer_neighbours(km)
        for side, cols in (("forward", slice(0, 4)), ("backward", slice(4, 8))):
            for key, v in ref[side].items():
                assert np.array_equal(got[key][:, cols], v), (side, key)
    assert (got["kmer_id"] != INVALID).any()


def check_streaming(name, jax_device=True):
    """Reads cut from the index (half reverse-complemented, 1% substituted)
    and random reads with Ns: the port's report (the plain step on the CPU)
    equals both host _Batchers and, with jax_device, JAX's device
    stream."""
    idx, jidx = case(name)[:2]
    rng = np.random.default_rng(11)
    strings = synthetic.index_strings(idx)
    L_ = min(2 * idx.k, min(len(s) for s in strings))
    reads = synthetic.cut_reads(strings, 150, L_, rng, rc=0.5, subst=0.01)
    reads = synthetic.with_n(reads + synthetic.random_reads(100, L_, rng), 0.05, rng)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reads.fq")
        synthetic.write_reads(path, [reads[i] for i in rng.permutation(len(reads))])
        rep = ST.streaming_query_from_file(Dictionary(idx), path, device="cpu", chunk=1 << 16,
                                           rmax_shift=6)
        assert rep.pop("elapsed_millisec") >= 0
        if jax_device:
            want = JS.streaming_query_from_file(sshash_tpu.Dictionary(jidx), path,
                                                use_device=True)
            assert rep == {key: want[key] for key in rep}
        assert rep == ST.host_report(idx, path)
        jhost = JS.streaming_query_from_file(sshash_tpu.Dictionary(jidx), path, use_device=False)
        assert rep == {key: jhost[key] for key in rep}
    assert 0 < rep["num_positive_kmers"] < rep["num_kmers"]


def check_sharded(name, shape):
    """The LocalMesh sharded engine: lookup in every field equals the
    unsharded engine's and JAX's DeviceEngine's; access of every id and
    weight equal the unsharded engine's."""
    idx, _, eng, _, q = case(name)[:5]
    seng = ShardedEngine(idx, LocalMesh(shape, "cpu"))
    got, rep = seng.lookup(q)
    want = jax_lookup(name)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    assert rep["num_positive"] == int((want["kmer_id"] != INVALID).sum())
    ids = np.arange(idx.num_kmers)
    assert np.array_equal(seng.access(ids), eng.access(ids))
    if idx.weights is not None:
        assert np.array_equal(seng.weight(ids), eng.weight(ids))


K65 = ("k65", "k65_canonical")


@pytest.mark.parametrize("name", K65)
def test_layout_equals_jax(name):
    check_layout(name)


@pytest.mark.parametrize("name", K65)
def test_lookup_equals_jax_and_oracles(name):
    check_lookup(name)


def test_canonical_ties_equal_jax_cond_path():
    check_ties("k65_canonical")


def test_tie_batch_through_the_engine_equals_the_oracles():
    """tie_batch given a TorchEngine (access, tie_lanes and lookup on its
    device, in chunks) picks the oracle form's hits and misses."""
    idx, _, eng = case("k65_canonical")[:3]
    want = synthetic.tie_batch(idx, np.random.default_rng(7), TIES)
    got = synthetic.tie_batch(idx, np.random.default_rng(7), TIES, engine=eng, chunk=1000)
    for g, w in zip(got, want):
        assert len(w) >= TIES // 2 and np.array_equal(g, w)
    km = oracle.access(idx, np.arange(idx.num_kmers))
    assert np.array_equal(synthetic.tie_lanes(eng, eng.kmers32(km)).numpy(),
                          synthetic.tie_kmers(idx, km))


@pytest.mark.parametrize("name", K65)
def test_access_iteration_weight_equal_jax(name):
    windowed = check_access_iteration_weight(name)
    # k65 has up to two string starts in a 32-id block: the two-round form
    assert windowed == (name == "k65_canonical")


# JAX's device programs compile for a minute or more at k65: navigation
# is held to JAX's DeviceEngine on the regular index (its RC fallback) and
# streaming to JAX's device stream on the canonical one; both to the
# oracles on both
@pytest.mark.parametrize("name", K65)
def test_navigation_equals_jax(name):
    check_navigation(name, jax_device=name == "k65")


@pytest.mark.parametrize("name", K65)
def test_streaming_equals_jax_and_host(name):
    check_streaming(name, jax_device=name == "k65_canonical")


@pytest.mark.parametrize("name,shape", [("k65", (2, 2)), ("k65_canonical", (1, 4))])
def test_sharded_lookup_equals_jax(name, shape):
    check_sharded(name, shape)


def test_wide_configurations_reach_every_probe_path():
    """Between them, the wide configurations hold candidate 1 in the row,
    mid buckets past it, heavy (skew) buckets, both access row forms and
    every kernel width form: fixed W = 5 and 8, and the runtime-width form
    (W = 9)."""
    cfgs = {name: L.StaticCfg(synthetic.small_index(name)) for name in synthetic.WIDE_CONFIGS}
    assert {c.W for c in cfgs.values()} == {5, 8, 9}
    assert any(c.c1_in_row for c in cfgs.values())
    assert any(c.has_skew and c.canonical for c in cfgs.values())
    assert {L.acc_windowed(c.k, c.access_C) for c in cfgs.values()} == {True, False}
    assert any(c.weighted for c in cfgs.values())


@pytest.mark.parametrize("k", [256, 300])
def test_refuses_k_past_255(k):
    """The kernels' widest form holds 16 u32 words: k > 255 raises, naming
    the cap (a deviation by design: no reference configuration goes past
    k = 63, and m <= 31 keeps a minimizer in one u64)."""
    wide = dataclasses.replace(synthetic.small_index("k65"), k=k)
    with pytest.raises(ValueError, match="k <= 255"):
        L.check_supported(wide)
    with pytest.raises(ValueError, match="k <= 255"):
        TorchEngine(wide, "cpu")
    assert L.MAX_K == 255


def test_k255_serves_on_the_cpu():
    """The widest kmer the kernels take, k = 255 (16 words), builds, looks
    up, accesses and iterates exactly (port against its oracle)."""
    idx = synthetic.build_index(k=255, m=31, canonical=True, num_strings=6, string_len=400,
                                seed=21)
    eng = TorchEngine(idx, "cpu")
    assert eng.cfg.W == 16
    q, _ = synthetic.query_batch(idx)
    got, want = eng.lookup(q), oracle.lookup(idx, q)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    ids = np.arange(idx.num_kmers)
    assert np.array_equal(eng.access(ids), oracle.access(idx, ids))
    assert eng.iterator()[0] == idx.num_kmers
    assert torch.equal(E.iterate_plain(255, eng.tables["strings32"], eng.tables["vstart32"]),
                       eng.iterator_device())
