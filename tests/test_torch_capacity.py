"""The capacity formats of the port against the JAX package and the oracle,
on the CPU: rebased (v2) rows, the two legacy skew forms (skew classes
without hindex, and with plain class MPHFs), ids from 2^31 up to 2^32 - 2,
and v2 rows built past 2^32 chars. The JAX side picks its formats through
its own environment switches (SSHASH_ROW_V2, SSHASH_WIDE_IDS), set with
monkeypatch; the port takes row_format. All outputs are integers: the
tolerance is 0."""

import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sshash_tpu
from sshash_tpu import oracle
from sshash_tpu import streaming as JS
from sshash_tpu.engine import DeviceEngine, StaticCfg as JaxCfg, _device_arrays
from sshash_tpu.engine import row_width as jax_row_width
from sshash_tpu_torch import Dictionary, TorchEngine, synthetic
from sshash_tpu_torch import kmer as K
from sshash_tpu_torch import layout as L
from sshash_tpu_torch import streaming as ST
from sshash_tpu_torch.engine import _to_host_result
from sshash_tpu_torch.index import Index
from test_torch_host import _reload, assert_same_index, jax_index
from one_thread import one_torch_thread  # noqa: F401

IDS_KEYS = ("kmer_id", "kmer_orientation", "minimizer_found")
INVALID = np.uint64(2 ** 64 - 1)
BASE = (1 << 31) + 12345
M32 = 0xFFFFFFFF


@pytest.fixture(scope="module", params=sorted(synthetic.SMALL_CONFIGS))
def v2case(request):
    """A small index, its query batch, the oracle's answers, and the JAX
    engine and table dict built with SSHASH_ROW_V2=1."""
    name = request.param
    idx = synthetic.small_index(name)
    q, _ = synthetic.query_batch(idx)
    jidx = jax_index(idx)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SSHASH_ROW_V2", "1")
        jeng = DeviceEngine(jidx)
        jarrs = _device_arrays(jidx)
    assert jeng.cfg.row_v2
    return name, idx, q, oracle.lookup(jidx, q), jeng, jarrs


def test_v2_tables_equal_jax(v2case):
    """The port's v2 tables equal JAX's after port_tables drops sid0 from
    every JAX block (and pads cw_row as row_pad says)."""
    name, idx, _, _, jeng, jarrs = v2case
    cfg = L.StaticCfg(idx, "v2")
    assert cfg.row_v2 and cfg.quad_w == jeng.cfg.quad_w - 1 == 2
    nblk = 2 if cfg.c1_in_row else 1
    assert jax_row_width(jeng.cfg) == jarrs["cw_row"].shape[1]
    assert L.row_width(cfg) == jax_row_width(jeng.cfg) - nblk + L.row_pad(cfg)
    port = L.device_arrays(idx, "v2")
    conv = L.port_tables(cfg, jarrs)
    assert set(port) <= set(conv)
    for key, v in port.items():
        assert v.dtype == np.uint32, key
        assert np.array_equal(v, conv[key]), f"{name}: {key}"
    assert not L.StaticCfg(idx).row_v2 and L.StaticCfg(idx).quad_w == 4


def test_v2_lookup_equals_jax_and_oracle(v2case):
    name, idx, q, want, jeng, _ = v2case
    eng = TorchEngine(idx, "cpu", row_format="v2")
    got, jgot = eng.lookup(q), jeng.lookup(q)
    assert set(got) == set(jgot) == set(IDS_KEYS)
    for key in IDS_KEYS:
        assert np.array_equal(got[key], want[key]), f"{name}: {key} vs oracle"
        assert np.array_equal(got[key], jgot[key]), f"{name}: {key} vs jax"
    ids = _to_host_result(eng.lookup_ids_device(eng.kmers32(q)))
    for key in IDS_KEYS:
        assert np.array_equal(ids[key], want[key]), key
    assert np.array_equal(eng.is_member(q), jeng.is_member(q))
    assert np.array_equal(eng.is_member(q), want["kmer_id"] != INVALID)


def test_v2_neighbours_equal_jax(v2case):
    name, idx, q, _, jeng, _ = v2case
    eng = TorchEngine(idx, "cpu", row_format="v2")
    km = q[:257]
    got, jgot = eng.kmer_neighbours(km), jeng.kmer_neighbours(km)
    assert set(got) == set(jgot) == set(IDS_KEYS)
    for key in IDS_KEYS:
        assert np.array_equal(got[key], jgot[key]), f"{name}: {key}"
    # the v1 engine's full navigation agrees on the id fields
    full = TorchEngine(idx, "cpu").kmer_neighbours(km)
    for key in IDS_KEYS:
        assert np.array_equal(got[key], full[key]), key


def test_v2_access_and_iterator_equal_jax(v2case):
    name, idx, _, _, jeng, _ = v2case
    eng = TorchEngine(idx, "cpu", row_format="v2")
    ids = np.arange(idx.num_kmers)
    got = eng.access(ids)
    assert np.array_equal(got, jeng.access(ids))
    assert np.array_equal(got, oracle.access(idx, ids))
    count, checksum = eng.iterator()
    jcount, jchecksum = (np.asarray(x) for x in jeng._iterator(jeng.arrs))
    assert (count, checksum) == (jcount, jchecksum) and count == idx.num_kmers


def test_v2_tables_from_jax_dict(v2case):
    """JAX's own v2 table dict feeds the port, with the same answers."""
    name, idx, q, want, _, jarrs = v2case
    cfg = L.StaticCfg(idx, "v2")
    own = L.tables_from_host(L.device_arrays(idx, "v2"), "cpu", cfg)
    from_jax = L.tables_from_host(jarrs, "cpu", cfg)
    assert set(own) == set(from_jax)
    for key in own:
        assert torch.equal(own[key], from_jax[key]), key
    got = TorchEngine(idx, "cpu", host_arrs=jarrs, row_format="v2").lookup(q)
    for key in IDS_KEYS:
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("name", ["m3_skew", "m3_skew_canonical"])
@pytest.mark.parametrize("plain_mphf", [False, True], ids=["no_hindex", "plain_mphf"])
def test_legacy_skew_equals_jax_and_oracle(name, plain_mphf):
    """Both pre-v1.2 skew forms: the tables equal JAX's (which takes the
    sk_positions path by itself) as port_tables converts them, sk_hrows in
    place of heavy_rows and sk_positions (without plain class MPHFs, the
    v1.2 form's tables, array for array), and lookup equals JAX's
    DeviceEngine, the oracle and the v1.2 form in every field; v2 rows
    over the legacy form give the same ids. Index.save/load keeps the
    form."""
    idx0 = synthetic.small_index(name)
    idx = synthetic.legacy_skew(idx0, plain_mphf=plain_mphf)
    assert all(p.hindex is None for p in idx.skew_partitions)
    jidx = jax_index(idx)
    cfg, jcfg = L.StaticCfg(idx), JaxCfg(jidx)
    assert cfg.has_skew and not jcfg.skew_hrows
    assert cfg.skew_partitioned == jcfg.skew_partitioned == (not plain_mphf)
    jarrs = _device_arrays(jidx)
    assert "sk_positions" in jarrs
    port = L.device_arrays(idx)
    assert "sk_hrows" in port and not set(L.LEGACY_KEYS) & set(port)
    conv = L.port_tables(cfg, jarrs, idx)
    assert set(port) <= set(conv)
    for key, v in port.items():
        assert np.array_equal(v, conv[key]), key
    if not plain_mphf:
        for key, v in L.device_arrays(idx0).items():
            assert np.array_equal(v, port[key]), key
    q, npos = synthetic.query_batch(idx0)
    want = oracle.lookup(jidx, q)
    got = TorchEngine(idx, "cpu").lookup(q)
    jgot = DeviceEngine(jidx).lookup(q)
    v12 = TorchEngine(idx0, "cpu").lookup(q)
    for key in want:
        assert np.array_equal(got[key], want[key]), f"{key} vs oracle"
        assert np.array_equal(got[key], jgot[key]), f"{key} vs jax"
        assert np.array_equal(got[key], v12[key]), f"{key} vs v1.2 form"
    assert (got["kmer_id"][:npos] != INVALID).all()
    v2 = TorchEngine(idx, "cpu", row_format="v2").lookup(q)
    for key in IDS_KEYS:
        assert np.array_equal(v2[key], want[key]), key
    for fmt in ("npz", "dir"):
        back = _reload(idx, Index.load, fmt)
        assert_same_index(idx, back)
        assert all(p.hindex is None for p in back.skew_partitions)
        assert np.array_equal(TorchEngine(back, "cpu").lookup(q)["kmer_id"], want["kmer_id"])


def test_legacy_skew_counts_heavy_lanes():
    """The legacy forms keep every heavy kmer: each plain class MPHF is a
    bijection onto its class's positions."""
    idx = synthetic.small_index("m3_skew_canonical")
    leg = synthetic.legacy_skew(idx, plain_mphf=True)
    for old, new in zip(idx.skew_partitions, leg.skew_partitions):
        assert new.mphf.n == old.mphf.n
        assert np.array_equal(np.sort(new.positions), np.sort(old.positions))
    assert sum(p.mphf.n for p in leg.skew_partitions) > 0


@pytest.mark.parametrize("name", ["m13_canonical", "m9_c1"])
def test_wide_ids_equal_jax(name, monkeypatch):
    """JAX's wide-id forms (the two-column pair scatter, the stream's
    two-column carry) give the port's answers: the port holds every id as
    u32 and has no narrow form."""
    monkeypatch.setenv("SSHASH_WIDE_IDS", "1")
    idx = synthetic.small_index(name)
    jd = sshash_tpu.Dictionary(jax_index(idx))
    jeng = jd.to_device()
    assert jeng.cfg.wide_ids
    q, _ = synthetic.query_batch(idx)
    eng = TorchEngine(idx, "cpu")
    kt = eng.kmers32(q)
    jres = jeng._lookup_ids(jeng.arrs, jnp.asarray(kt.numpy().view(np.uint32)))
    got = eng.lookup_ids_device(kt)
    assert np.array_equal(got["kmer_id"].numpy().view(np.uint32), np.asarray(jres["kmer_id"]))
    for key in ("kmer_orientation", "minimizer_found"):
        assert np.array_equal(got[key].numpy(), np.asarray(jres[key])), key
    if name != "m13_canonical":
        return
    rng = np.random.default_rng(3)
    strings = synthetic.index_strings(idx)
    reads = synthetic.cut_reads(strings, 300, 80, rng, rc=0.5, subst=0.01)
    reads += synthetic.random_reads(100, 80, rng)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reads.fq")
        synthetic.write_reads(path, reads)
        jrep = JS.streaming_query_from_file(jd, path, use_device=True, chunk=1 << 16)
        rep = ST.streaming_query_from_file(Dictionary(idx), path, device="cpu", chunk=1 << 16)
    jrep.pop("elapsed_millisec", None)
    rep.pop("elapsed_millisec")
    assert rep == {key: jrep[key] for key in rep} and rep["num_positive_kmers"] > 0


@pytest.mark.parametrize("name", ["m3_skew_canonical", "m9_c1"])
def test_ids_above_2_31(name):
    """v2 tables whose kid0 is rebased by BASE (synthetic.rebase_ids): every
    found id comes back as the v1 id + BASE mod 2^32 (all at or above
    2^31) through the plain probe and the lookup glue, every miss as
    0xFFFFFFFF, and the host result holds them as uint64."""
    idx = synthetic.small_index(name)
    q, npos = synthetic.query_batch(idx)
    want = oracle.lookup(idx, q)["kmer_id"]
    eng = TorchEngine(idx, "cpu", row_format="v2")
    hi = synthetic.rebase_ids(eng.cfg, eng.tables, BASE)
    res = _to_host_result(eng._lookup_ids(hi, eng.kmers32(q)))
    found = want != INVALID
    assert found[:npos].all()
    expect = np.where(found, (want + np.uint64(BASE)) & np.uint64(M32), INVALID)
    assert np.array_equal(res["kmer_id"], expect)
    assert (res["kmer_id"][found] >= np.uint64(1 << 31)).all()
    own = _to_host_result(eng.lookup_ids_device(eng.kmers32(q)))
    for key in ("kmer_orientation", "minimizer_found"):
        assert np.array_equal(res[key], own[key]), key


def _ares(rng, A, akid, fwd):
    """Anchor lookups whose every other field is random."""
    i32 = lambda v: torch.from_numpy(np.asarray(v, dtype=np.uint32).view(np.int32))  # noqa: E731
    off = rng.integers(16, 1 << 12, A)
    return {"found": torch.from_numpy(rng.random(A) < 0.8),
            "kmer_offset": i32(off), "string_id": i32(rng.integers(0, 8, A)),
            "kmer_id": i32(akid), "kmer_orientation": torch.from_numpy(
                np.where(fwd, 1, -1).astype(np.int32)),
            "string_begin": i32(off - 16), "string_end": i32(off + 64)}


def test_stream_stages_hold_ids_near_2_32():
    """The chain's per-lane ids (akid +- t) and the counters' extension
    test (kid == previous kid + orientation) wrap mod 2^32 as a NumPy u32
    model does, and no flag reads an id's top bit."""
    rng = np.random.default_rng(7)
    k, A = 31, 64
    P = 16 * A
    fwd = rng.random(A) < 0.5
    akid = np.where(fwd, (1 << 32) - 9 - rng.integers(0, 4, A), rng.integers(0, 9, A))
    words = torch.from_numpy(rng.integers(0, 1 << 32, P // 8, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
    strings = torch.from_numpy(rng.integers(0, 1 << 32, 1 << 10, dtype=np.uint64)
                               .astype(np.uint32).view(np.int32))
    bits = lambda p: torch.from_numpy(  # noqa: E731
        np.packbits(rng.random(P // 32 * 32 + 32) < p, bitorder="little").view(np.int32))
    valid, sbits, fbits = bits(0.95), bits(0.02), bits(0.01)
    cum_g = torch.from_numpy(np.cumsum(rng.integers(0, 2, A)).astype(np.int32))
    ares = _ares(np.random.default_rng(1), A, akid, fwd)
    out = ST.stream_chain_plain(ares, words, strings, valid, sbits, fbits, cum_g, k)
    t = np.arange(16)
    model = np.where(fwd[:, None], akid[:, None] + t, akid[:, None] - t) % (1 << 32)
    assert np.array_equal(out["kmer_id"].numpy().view(np.uint32), model.reshape(-1))
    assert (model >= 1 << 31).any() and (model < 1 << 31).any()
    low = ST.stream_chain_plain(_ares(np.random.default_rng(1), A, akid % 1000, fwd), words,
                                strings, valid, sbits, fbits, cum_g, k)
    for key in ("found", "need", "string_id", "kmer_orientation"):
        assert torch.equal(out[key], low[key]), key
    # counters over lanes whose ids run across 2^32
    kid = ((1 << 32) - P // 2 + np.arange(P)) % (1 << 32)
    ori = np.ones(P, dtype=np.int32)
    found = rng.random(P) < 0.9
    state = {"found": torch.from_numpy(found.astype(np.uint8)),
             "string_id": torch.zeros(P, dtype=torch.int32),
             "kmer_id": torch.from_numpy(kid.astype(np.uint32).view(np.int32)),
             "kmer_orientation": torch.from_numpy(ori)}
    count = torch.tensor([P], dtype=torch.int32)
    got = ST.stream_count_plain(state, valid, fbits, count).numpy().view(np.uint32)
    vb = np.unpackbits(valid.numpy().view(np.uint8), bitorder="little")[:P] != 0
    fb = np.unpackbits(fbits.numpy().view(np.uint8), bitorder="little")[:P] != 0
    f = found & vb
    k32 = kid.astype(np.uint32)
    ext = f[1:] & f[:-1] & ~fb[1:] & (k32[1:] == k32[:-1] + np.uint32(1))
    assert list(got[0]) == [P, f.sum(), ext.sum(), P - vb.sum()]
    assert got[2, 2] == k32[-1] and got[1, 2] == k32[0]
    # the merge writes the rounds' ids bit for bit
    lanes = torch.arange(P, dtype=torch.int32)
    r = {"found": torch.ones(P, dtype=torch.bool), "string_id": state["string_id"],
         "kmer_id": state["kmer_id"], "kmer_orientation": state["kmer_orientation"]}
    blank = {key: torch.zeros_like(v) for key, v in state.items()}
    merged = ST.stream_merge_plain(lanes, count, r, r, blank)
    assert torch.equal(merged["kmer_id"], state["kmer_id"])


class _Shifted:
    """The packed strings of a small index placed `base` words up, zero
    words below: a zero-copy stand-in for a string set of >= 2^32 chars."""

    def __init__(self, s32, base):
        self.s32, self.base = s32, base

    def __len__(self):
        return self.base + len(self.s32)

    def __getitem__(self, i):
        i = np.asarray(i, dtype=np.int64)
        return np.where(i >= self.base, self.s32[np.clip(i - self.base, 0, len(self.s32) - 1)],
                        np.uint32(0))


@pytest.mark.parametrize("name", ["m13_canonical", "m3_skew"])
def test_v2_rows_past_2_32_chars(name):
    """v2 rows of a string set placed past 2^32 chars (F filler strings
    before the index's own, read through a view): kid0 (from sid0), rel_ep1
    and col0 hold int64 arithmetic, not values wrapped at 2^32, and the plain
    probe over tables built from them resolves every id to the oracle's
    off - sid*(k-1) there."""
    idx = synthetic.small_index(name)
    k, m, kmw = idx.k, idx.m, idx.k - idx.m
    chars = (1 << 32) + (1 << 20)  # a multiple of 16: words shift whole
    F = 40_000  # filler strings; shift of the ids: chars - F*(k-1)
    ep_small = idx.string_endpoints.astype(np.int64)
    ep = np.concatenate([np.linspace(0, chars, F + 1).astype(np.int64),
                         chars + ep_small[1:]])
    shift = chars - F * (k - 1)
    assert 1 << 31 < shift < (1 << 32) - idx.num_kmers - 1
    s32 = _Shifted(K.pack_words_to_u32(idx.strings64), chars // 16)

    def rows(dpos):
        return L.fused_rows(np.asarray(dpos, np.int64) + chars, s32, ep, k, m, True)

    cand = np.unique(np.concatenate([np.asarray(idx.mid_load_buckets, np.int64),
                                     np.asarray(idx.heavy_load_buckets, np.int64),
                                     np.arange(0, idx.num_chars, 7)]))
    got = rows(cand)
    c0 = cand + chars
    assert (c0 >= 1 << 32).all()
    sid0 = np.searchsorted(ep, np.maximum(c0 - kmw, 0), side="right") - 1
    ep1 = ep[sid0 + 1]
    assert got.shape[1] == L.cand_block_width(L.StaticCfg(idx, "v2"))
    quad = got[:, -2:].astype(np.int64)  # the resolve words kid0, rel_ep1
    assert np.array_equal(quad[:, 0], c0 - sid0 * (k - 1))
    assert np.array_equal(quad[:, 1], np.clip(ep1 - (c0 - kmw), 0, kmw + 1))
    assert np.array_equal(got[:, 0], c0 - ((np.maximum(c0 - kmw, 0) >> 4) << 4))
    # candidates at least k-m chars into the strings keep their small rows'
    # windows and valid-start bits
    small = L.fused_rows(cand, K.pack_words_to_u32(idx.strings64), ep_small, k, m, True)
    inner = cand >= kmw
    assert np.array_equal(got[inner, :-2], small[inner, :-2])
    # their strings sit F further up, so kid0 (c0 - sid0*(k-1)) moves by shift
    assert np.array_equal(quad[inner, 0], small[inner, -2].astype(np.int64) + shift)
    # the probe over tables of these rows answers shift + the small id
    cfg = L.StaticCfg(idx, "v2")
    host = L.device_arrays(idx, "v2")
    host.update(L.lookup_tables(idx, cfg, rows))
    eng = TorchEngine(idx, "cpu", host_arrs=host, row_format="v2")
    q, npos = synthetic.query_batch(idx)
    want = oracle.lookup(idx, q)
    got = eng.lookup(q)
    found = want["kmer_id"] != INVALID
    off = want["kmer_offset"][found].astype(np.int64) + chars
    sid = want["string_id"][found].astype(np.int64) + F
    assert np.array_equal(got["kmer_id"][found].astype(np.int64), off - sid * (k - 1))
    assert (got["kmer_id"][~found] == INVALID).all()
    assert (got["kmer_id"][found] >= np.uint64(1 << 31)).all()
    assert np.array_equal(got["kmer_orientation"], want["kmer_orientation"])
