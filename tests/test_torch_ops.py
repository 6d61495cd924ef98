"""The port's plain u64, packed-string, minimizer and probe functions against
the JAX package's ops/u64.py, ops/packed.py and engine.lookup_with_info (JAX
on the CPU) and the host hashing.py, on the same numpy-seeded inputs.
Every output is an integer: the tolerance is 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sshash_tpu import hashing as H
from sshash_tpu import kmer as K
from sshash_tpu import oracle
from sshash_tpu.engine import DeviceEngine
from sshash_tpu.engine import StaticCfg as JaxCfg
from sshash_tpu.engine import _device_arrays, lookup_with_info
from sshash_tpu.engine import _to_host_result as jax_host
from sshash_tpu.ops import packed as JP
from sshash_tpu.ops import u64 as JU
from sshash_tpu_torch import TorchEngine, kernels, synthetic
from sshash_tpu_torch.engine import _to_host_result, canonical_fold, probe, probe_plain
from sshash_tpu_torch.layout import StaticCfg, device_arrays, tables_from_host
from sshash_tpu_torch.ops import packed as P
from test_torch_host import jax_index
from sshash_tpu_torch.ops import u64 as u
from one_thread import one_torch_thread  # noqa: F401


def _t(a):
    """numpy unsigned -> int64 torch tensor of the same values."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _pair(x64):
    x64 = np.asarray(x64, dtype=np.uint64)
    return u.u64(_t(x64 >> np.uint64(32)), _t(x64 & np.uint64(0xFFFFFFFF)))


def _np64(p):
    return (p.hi.numpy().astype(np.uint64) << np.uint64(32)) | p.lo.numpy().astype(np.uint64)


def _jpair(x64):
    x64 = np.asarray(x64, dtype=np.uint64)
    return JU.u64(jnp.asarray((x64 >> np.uint64(32)).astype(np.uint32)),
                  jnp.asarray((x64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def test_u64_hashes_match_host_and_jax():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 1 << 64, 4096, dtype=np.uint64)
    seed = np.uint64(0x1234567890ABCDEF)
    magic = int(H.mixer_magic(7))
    a32 = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    b32 = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)

    got = _np64(u.splitmix64(_pair(x)))
    assert np.array_equal(got, H.splitmix64(x))
    assert np.array_equal(got, JU.to_np(JU.splitmix64(_jpair(x))))
    got = _np64(u.mixer64(_pair(x), magic))
    assert np.array_equal(got, H.mixer64(x, magic))
    assert np.array_equal(got, JU.to_np(JU.mixer64(_jpair(x), JU.const64(magic))))
    got = _np64(u.hash64_u64(_pair(x), _pair(H.splitmix64(seed))))
    assert np.array_equal(got, H.hash64_u64(x, seed))
    got = u.fmix32(_t(a32)).numpy()
    assert np.array_equal(got, H.fmix32(a32.copy()))  # fmix32 works in place
    assert np.array_equal(got, np.asarray(JU.fmix32(jnp.asarray(a32))))
    got = u.mulhi32(_t(a32), _t(b32)).numpy()
    assert np.array_equal(got, H.mulhi32(a32, b32))
    assert np.array_equal(got, np.asarray(JU.mulhi32(jnp.asarray(a32), jnp.asarray(b32))))
    assert np.array_equal(u.mullo32(_t(a32), _t(b32)).numpy(),
                          (a32.astype(np.uint64) * b32.astype(np.uint64)) & np.uint64(0xFFFFFFFF))
    for W in (1, 2, 3, 4):
        words = rng.integers(0, 1 << 32, (512, W), dtype=np.uint64).astype(np.uint32)
        got = _np64(u.hash64_words(_t(words), _pair(H.splitmix64(seed))))
        assert np.array_equal(got, H.hash64_words(words, seed))


def _kmers32(rng, n, k):
    return K.kmers_to_u32(synthetic.random_kmers(k, rng, n), k)


@pytest.mark.parametrize("k", [16, 31, 33, 63, 65, 127, 129, 255])
def test_packed_ops_match_jax(k):
    rng = np.random.default_rng(k)
    k32 = _kmers32(rng, 1024, k)
    km, jk = _t(k32), jnp.asarray(k32)
    assert np.array_equal(P.revcomp_kmers(km, k).numpy(), np.asarray(JP.revcomp_kmers(jk, k)))
    assert np.array_equal(P.crc32_word(km).numpy(), np.asarray(JP.crc32_word(jk)))
    other = _t(np.where(rng.random(k32.shape) < 0.7, k32, _kmers32(rng, 1024, k)))
    jo = jnp.asarray(other.numpy().astype(np.uint32))
    assert np.array_equal(P.kmer_less(km, other).numpy(), np.asarray(JP.kmer_less(jk, jo)))
    assert np.array_equal(P.kmer_equal(km, other).numpy(), np.asarray(JP.kmer_equal(jk, jo)))
    m = min(31, k - 1)
    for bit in (0, 2, 30, 2 * (k - m)):
        got = P.extract_window(km, bit, 2 * m)
        want = JP.extract_window(jk, bit, 2 * m)
        assert np.array_equal(_np64(got), JU.to_np(want))
    # per-lane offsets over a wider window, with and without the start-word bound
    nwin = max(9, (2 * k + 31) // 32 + 2)
    win = rng.integers(0, 1 << 32, (1024, nwin), dtype=np.uint64).astype(np.uint32)
    bitpos = (2 * rng.integers(0, 16 * nwin, 1024)).astype(np.uint32)
    for msw in (None, 1, 3):
        got = P.extract_kmer_dyn(_t(win), _t(bitpos), k, msw).numpy()
        want = np.asarray(JP.extract_kmer_dyn(jnp.asarray(win), jnp.asarray(bitpos), k, msw))
        assert np.array_equal(got, want)
        got = P.extract_window_dyn(_t(win), _t(bitpos), 2 * m, msw)
        want = JP.extract_window_dyn(jnp.asarray(win), jnp.asarray(bitpos), 2 * m, msw)
        assert np.array_equal(_np64(got), JU.to_np(want))
    mm = rng.integers(0, 1 << (2 * m), 1024, dtype=np.uint64)
    assert np.array_equal(_np64(P.revcomp_mmer64(_pair(mm), m)),
                          JU.to_np(JP.revcomp_mmer64(_jpair(mm), m)))


@pytest.mark.parametrize("k,m", [(31, 13), (31, 17), (31, 21), (63, 25), (15, 7), (65, 21),
                                 (65, 25), (127, 31), (129, 31)])
def test_minimizer_matches_jax(k, m):
    rng = np.random.default_rng(k * 100 + m)
    k32 = _kmers32(rng, 2048, k)
    # repeated windows make hash ties, which the tie rules decide
    k32[:256] = np.uint32(0)
    k32[256:512] = np.uint32(0x55555555) & k32[256:512]
    magic = int(H.mixer_magic(1))
    jm = JU.const64(magic)
    mv, mp = P.compute_minimizer(_t(k32), k, m, magic)
    jv, jp = JP.compute_minimizer(jnp.asarray(k32), k, m, jm)
    assert np.array_equal(_np64(mv), JU.to_np(jv))
    assert np.array_equal(mp.numpy(), np.asarray(jp))
    got = P.compute_minimizer_two_strand(_t(k32), k, m, magic)
    rc32 = JP.revcomp_kmers(jnp.asarray(k32), k)
    want = JP.compute_minimizer_two_strand(jnp.asarray(k32), rc32, k, m, jm)
    for g, w in zip(got, want):
        g = _np64(g) if isinstance(g, u.u64) else g.numpy()
        w = JU.to_np(w) if isinstance(w, JU.u64) else np.asarray(w)
        assert np.array_equal(g, w)
    # the kernel-1 contract: int32 kmers in, int64 values and int32 positions out
    before = kernels.counts()
    out = P.minimizer(torch.from_numpy(k32.view(np.int32)), k, m, magic, both=True)
    assert kernels.counts() == before  # a CPU tensor never reaches the kernel
    assert [t.dtype for t in out] == [torch.int64, torch.int32, torch.int32,
                                      torch.int64, torch.int32]
    assert np.array_equal(out[2].numpy().view(np.uint32), np.asarray(rc32))
    assert np.array_equal(out[3].numpy().astype(np.uint64), JU.to_np(want[2]))
    # the host oracle agrees on the forward strand
    hv, hp = oracle.compute_minimizer(K.u32_to_kmers64(k32, k), k, m, np.uint64(magic))
    assert np.array_equal(out[0].numpy().astype(np.uint64), hv)
    assert np.array_equal(out[1].numpy(), hp)


READ2_CONFIGS = {15: "k15", 31: "m13_regular", 63: "k63", 65: "k65", 129: "k129_canonical"}


@pytest.mark.parametrize("k", sorted(READ2_CONFIGS))
def test_read_kmers_at2_matches_jax(k):
    """The read over the interleaved (NW, 2) table: on random words and
    bits, and on an index's strings32 and valid-start bits (where the bit
    says whether a kmer starts at the offset), offsets past the end
    included (reads clip to the last row)."""
    rng = np.random.default_rng(k)
    idx = synthetic.small_index(READ2_CONFIGS[k])
    arrs = device_arrays(idx)
    rand = rng.integers(0, 1 << 32, (2, 301), dtype=np.uint64).astype(np.uint32)
    for s32, v32 in ((rand[0], rand[1, :151]), (arrs["strings32"], arrs["vstart32"])):
        table = P.interleave_valid_starts(torch.from_numpy(s32.view(np.int32)),
                                          torch.from_numpy(v32.view(np.int32)))
        assert table.shape == (len(s32), 2)
        offsets = rng.integers(0, 16 * len(s32) + 64, 2000).astype(np.uint32)
        offsets[:16] = 16 * len(s32) - 1 - np.arange(16)
        got, vbit = P.read_kmers_at2(table, torch.from_numpy(offsets.view(np.int32)), k)
        want, wbit = JP.read_kmers_at2(jnp.asarray(table.numpy().view(np.uint32)),
                                       jnp.asarray(offsets), k)
        assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
        assert np.array_equal(vbit.numpy(), np.asarray(wbit))
    # on the index: the bit marks kmer starts, and the kmer there is the oracle's
    o = np.arange(idx.num_chars)
    starts = (arrs["vstart32"][o >> 5] >> (o & 31)) & 1 != 0
    assert np.array_equal(vbit.numpy()[offsets < idx.num_chars],
                          starts[offsets[offsets < idx.num_chars]])
    ids = rng.integers(0, idx.num_kmers, 500)
    offs = np.flatnonzero(starts)[ids].astype(np.uint32)
    got, vbit = P.read_kmers_at2(table, torch.from_numpy(offs.view(np.int32)), k)
    assert vbit.all()
    assert np.array_equal(K.u32_to_kmers64(got.numpy().view(np.uint32), k),
                          oracle.access(jax_index(idx), ids))


@pytest.mark.parametrize("name", ["m3_skew_canonical", "m9_c1", "partitioned"])
def test_probe_matches_jax_lookup_with_info(name):
    """The plain probe equals engine.lookup_with_info lane for lane, inactive
    lanes and the canonical tie tries included."""
    idx = synthetic.small_index(name)
    cfg, jcfg = StaticCfg(idx), JaxCfg(jax_index(idx))
    host = device_arrays(idx)
    tables = tables_from_host(host, "cpu", cfg)
    rng = np.random.default_rng(5)
    n = 1001
    ids = rng.integers(0, idx.num_kmers, n)
    km64 = oracle.access(idx, ids)
    km64[::2] = K.revcomp_kmers(km64[::2], idx.k)
    km64[-200:] = rng.integers(0, 1 << 62, (200, km64.shape[1]), dtype=np.uint64)
    k32 = K.kmers_to_u32(km64, idx.k)
    kt = torch.from_numpy(k32.view(np.int32))
    mv, mp, rc, mv_r, mp_r = P.minimizer(kt, idx.k, idx.m, cfg.magic, both=True)
    active = torch.from_numpy(rng.random(n) < 0.9)
    canon = idx.canonical
    mp2 = None
    if canon:
        mv, mp, mp2 = canonical_fold(mv, mp, mv_r, mp_r)
    got = probe_plain(cfg, tables, kt, rc if canon else None, mv, mp, mp2, active)
    assert got.keys() == probe(cfg, tables, kt, rc if canon else None, mv, mp, mp2,
                               active).keys()

    arrs = {key: jnp.asarray(v) for key, v in _device_arrays(jax_index(idx)).items()}
    mvn = mv.numpy().astype(np.uint64)

    def run(arrs, km, kmr, mhi, mlo, mpos, act, mpos2):
        return lookup_with_info(jcfg, arrs, km, kmr, JU.u64(mhi, mlo), mpos, act,
                                "full", minpos2=mpos2)

    want = jax.jit(run)(arrs, jnp.asarray(k32),
                        jnp.asarray(rc.numpy().view(np.uint32)) if canon else None,
                        jnp.asarray((mvn >> np.uint64(32)).astype(np.uint32)),
                        jnp.asarray((mvn & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
                        jnp.asarray(mp.numpy()), jnp.asarray(active.numpy()),
                        jnp.asarray(mp2.numpy()) if canon else None)
    assert set(got) == set(want)
    for key, v in want.items():
        g = got[key].numpy()
        g = g.view(np.uint32) if g.dtype == np.int32 and key != "kmer_orientation" else g
        assert np.array_equal(g, np.asarray(v)), key
    assert int(got["found"].sum()) > 0


def test_ids_mode_equals_jax_ids_kernel():
    """The id-only lookup against the JAX id-only kernel itself, on the
    configuration where candidate 1 rides the row and the sweep runs."""
    idx = synthetic.small_index("m3_skew")
    q, _ = synthetic.query_batch(idx, seed=1)
    eng, jeng = TorchEngine(idx, "cpu"), DeviceEngine(jax_index(idx))
    got = _to_host_result(eng.lookup_ids_device(eng.kmers32(q)))
    res = jeng._lookup_ids(jeng.arrs, jnp.asarray(K.kmers_to_u32(q, idx.k)))
    want = jax_host({key: np.asarray(v) for key, v in res.items()})
    assert set(got) == set(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
