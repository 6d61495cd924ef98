"""The port's CUDA kernels against their plain PyTorch versions and against
the JAX package's oracle and host stream, on the card.

This file imports no JAX (the JAX package's oracle, index and host stream
do not), so a machine with a card and no JAX runs it (tests/conftest.py
imports JAX, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Without a CUDA card the `cuda` tests skip (the kernels have no CPU mode);
the wrapper checks below run everywhere. Outputs are integers: tolerance 0.
"""

import os

import numpy as np
import pytest
import torch

import sshash_tpu
from sshash_tpu import oracle
from sshash_tpu import streaming as jax_streaming
from sshash_tpu.index import Index as JaxIndex
from sshash_tpu_torch import TorchEngine, debug, kernels, synthetic
from sshash_tpu_torch import kmer as K
from sshash_tpu_torch import engine as E
from sshash_tpu_torch import streaming as ST
from sshash_tpu_torch.engine import canonical_fold, probe, probe_plain, unpack_result
from sshash_tpu_torch.layout import AccessShard, ProbeShard, packed_rows
from sshash_tpu_torch.ops import packed as P
from sshash_tpu_torch.parallel import LocalMesh, ShardedEngine
from sshash_tpu_torch.parallel.mesh import combine, combine_plain
from sshash_tpu_torch.parallel.sharded import split_weight_runs
from one_thread import one_torch_thread  # noqa: F401


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def jax_index(idx, tmp_path):
    """The port's Index as the JAX package's (save, then load), for its
    oracle."""
    path = str(tmp_path / "index.npz")
    idx.save(path)
    return JaxIndex.load(path)


ALL_CONFIGS = sorted(synthetic.SMALL_CONFIGS) + sorted(synthetic.WIDE_CONFIGS)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ALL_CONFIGS)
def test_kernels_equal_plain_on_card(card, name, tmp_path):
    idx = synthetic.small_index(name)
    eng = TorchEngine(idx, card)
    q, _ = synthetic.query_batch(idx)
    kt = eng.kmers32(q)
    cfg = eng.cfg
    got = P.minimizer(kt, cfg.k, cfg.m, cfg.magic, both=True)
    want = P.minimizer_plain(kt, cfg.k, cfg.m, cfg.magic, both=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    mv, mp, rc, mv_r, mp_r = want
    args = (rc, *canonical_fold(mv, mp, mv_r, mp_r)) if cfg.canonical else (None, mv, mp, None)
    rng = np.random.default_rng(1)
    active = torch.from_numpy(rng.random(kt.shape[0]) < 0.9).to(card)
    for fields in ("full", "ids"):
        g = probe(cfg, eng.tables, kt, *args, active, fields)
        w = probe_plain(cfg, eng.tables, kt, *args, active, fields)
        assert g.keys() == w.keys()
        for key in w:
            assert torch.equal(g[key], w[key]), key
    host, want = eng.lookup(q), oracle.lookup(jax_index(idx, tmp_path), q)
    for key in want:
        assert np.array_equal(host[key], want[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("name", ALL_CONFIGS)
def test_point_query_kernels_equal_plain_on_card(card, name, tmp_path):
    """Access (both forms), iteration, weight and the neighbour variants."""
    idx = synthetic.small_index(name)
    jidx = jax_index(idx, tmp_path)
    eng = TorchEngine(idx, card)
    cfg, t = eng.cfg, eng.tables
    rng = np.random.default_rng(2)
    ids = np.concatenate([np.arange(idx.num_kmers), rng.integers(0, 1 << 32, 999)])
    it = torch.from_numpy(ids.astype(np.uint32).view(np.int32)).to(card)
    before = kernels.counts()
    got = E.access(cfg, t, it)
    assert torch.equal(got, E.access_plain(cfg, t, it))
    n = idx.num_kmers
    assert np.array_equal(eng.access(ids[:n]), oracle.access(jidx, ids[:n]))
    got = E.iterate(cfg.k, t["strings32"], t["vstart32"])
    assert torch.equal(got, E.iterate_plain(cfg.k, t["strings32"], t["vstart32"]))
    assert eng.iterator()[0] == jidx.num_kmers
    if cfg.weighted:
        assert torch.equal(E.weight(t, it), E.weight_plain(t, it))
        assert np.array_equal(eng.weight(ids[:n]), jidx.weights.weight(ids[:n]))
    kt = eng.kmers32(oracle.access(jidx, ids[:4096] % n))
    assert torch.equal(P.neighbour_variants(kt, cfg.k), P.neighbour_variants_plain(kt, cfg.k))
    after = kernels.counts()
    for kern in ("access_kernel", "iterate_kernel", "neighbours_kernel") + (
            ("weight_kernel",) if cfg.weighted else ()):
        assert after[kern] > before[kern], kern


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(synthetic.ACCESS_CONFIGS))
def test_access_rows_equal_plain_on_card(card, name, tmp_path):
    """The access kernel on rows of every width residue, C >= 2, the
    two-round form and W = 5 (synthetic.ACCESS_CONFIGS): every id of the
    index (every position of every 32-id block, the last block partial)
    and random ids past it equal the plain version, the in-range ones the
    oracle; on three shards cut unevenly (slices that start at any word of
    a segment), each round equals its plain version and the shards
    combine to the unsharded kernel's."""
    idx = synthetic.small_index(name)
    eng = TorchEngine(idx, card)
    cfg, t = eng.cfg, eng.tables
    n = idx.num_kmers
    ids = np.concatenate([np.arange(n), np.random.default_rng(9).integers(0, 1 << 32, 999)])
    it = torch.from_numpy(ids.astype(np.uint32).view(np.int32)).to(card)
    before = kernels.counts()["access_kernel"]
    got = E.access(cfg, t, it)
    assert kernels.counts()["access_kernel"] == before + 1
    assert torch.equal(got, E.access_plain(cfg, t, it))
    assert np.array_equal(eng.access(ids[:n]), oracle.access(jax_index(idx, tmp_path), ids[:n]))
    bc, wc = _cuts(t["acc_rows"].shape[0]), _cuts(t["strings32"].shape[0])
    ash = [AccessShard(a, b, c, d) for a, b, c, d in zip(bc, bc[1:], wc, wc[1:])]
    atabs = [dict(t, acc_rows=t["acc_rows"][s.blk_lo:s.blk_hi],
                  strings32=t["strings32"][s.word_lo:s.word_hi + cfg.W + 1]) for s in ash]
    firsts = []
    for sh, tab in zip(ash, atabs):
        firsts.append(E.access(cfg, tab, it, sh))
        assert torch.equal(firsts[-1], E.access_plain(cfg, tab, it, sh))
    if firsts[0].dim() == 1:
        off = _combine(firsts, "pmin")
        firsts = []
        for sh, tab in zip(ash, atabs):
            firsts.append(E.access_read(cfg, tab, off, sh))
            assert torch.equal(firsts[-1], E.access_read_plain(cfg, tab, off, sh))
    assert torch.equal(_combine(firsts, "pmax")[:n], got[:n])


BASE = (1 << 31) + 12345  # rebase_ids: every found id lands at or above 2^31


def _probe_args(cfg, kt):
    mv, mp, rc, mv_r, mp_r = P.minimizer_plain(kt, cfg.k, cfg.m, cfg.magic, both=True)
    return (rc, *canonical_fold(mv, mp, mv_r, mp_r)) if cfg.canonical else (None, mv, mp, None)


def shard_rounds(cfg, kt):
    """A lookup's kernel-2 rounds after kernel 1: [(kernel 2's args from
    the kmers on, rc_round)]: the canonical fold's one, or the regular
    mode's forward round and RC round."""
    mv, mp, rc, mv_r, mp_r = P.minimizer_plain(kt, cfg.k, cfg.m, cfg.magic, both=True)
    if cfg.canonical:
        return [((kt, rc, *canonical_fold(mv, mp, mv_r, mp_r)), False)]
    return [((kt, None, mv, mp, None), False), ((rc, None, mv_r, mp_r, None), True)]


MARK = 0x5A5A5A5A  # a sentinel no result field holds


def sentinel_result(fields, B, handoff, device):
    """Result tensors of the owned shard form holding a sentinel (ids MARK,
    orientation 7), plus "hrow" for the hand-off and "slot" for the lanes'
    MPHF slots."""
    out = {name: torch.full((B,), MARK, dtype=dt, device=device) if dt == torch.int32
           else torch.zeros(B, dtype=dt, device=device)
           for name, dt in kernels.result_dtypes(fields).items()}
    out["kmer_orientation"].fill_(7)
    for name in ("hrow",) * bool(handoff) + ("slot",):
        out[name] = torch.full((B,), MARK, dtype=torch.int32, device=device)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["m3_skew", "m3_skew_canonical", "partitioned", "k63",
                                  "k65_canonical", "k129_canonical"])
@pytest.mark.parametrize("form", ["v2", "legacy", "legacy_plain_mphf"])
def test_probe_variants_equal_plain_on_card(card, name, form, tmp_path):
    """Kernel 2 in v2 rows and in both legacy skew forms (hindex dropped;
    also plain class MPHFs) equals its plain version and the oracle; in v2,
    tables whose kid0 is rebased by BASE give every found id + BASE mod
    2^32 from both, and 0xFFFFFFFF on every miss."""
    idx = synthetic.small_index(name)
    v1 = TorchEngine(idx, card)
    if form == "v2":
        eng = TorchEngine(idx, card, row_format="v2")
    else:
        idx = synthetic.legacy_skew(idx, plain_mphf=form == "legacy_plain_mphf")
        eng = TorchEngine(idx, card)
    cfg = eng.cfg
    q, _ = synthetic.query_batch(idx)
    kt = eng.kmers32(q)
    args = _probe_args(cfg, kt)
    active = torch.from_numpy(np.random.default_rng(5).random(kt.shape[0]) < 0.9).to(card)
    for fields in ("ids",) if cfg.row_v2 else ("full", "ids"):
        g = probe(cfg, eng.tables, kt, *args, active, fields)
        w = probe_plain(cfg, eng.tables, kt, *args, active, fields)
        assert g.keys() == w.keys()
        for key in w:
            assert torch.equal(g[key], w[key]), key
    host, want = eng.lookup(q), oracle.lookup(jax_index(idx, tmp_path), q)
    assert set(host) == ({"kmer_id", "kmer_orientation", "minimizer_found"} if cfg.row_v2
                         else set(want))
    for key in host:
        assert np.array_equal(host[key], want[key]), key
    if cfg.row_v2:
        ref = probe(v1.cfg, v1.tables, kt, *args, None, "ids")
        expect = torch.where(ref["found"], (ref["kmer_id"].to(torch.int64) + BASE) & 0xFFFFFFFF,
                             0xFFFFFFFF)
        hi = synthetic.rebase_ids(cfg, eng.tables, BASE)
        for fn in (probe, probe_plain):
            got = fn(cfg, hi, kt, *args, None, "ids")
            assert torch.equal(got["kmer_id"].to(torch.int64) & 0xFFFFFFFF, expect)
            assert torch.equal(got["found"], ref["found"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["m13_regular", "m3_skew", "m3_skew_canonical", "m9_c1",
                                  "partitioned", "k63", "k65", "k129_canonical"])
def test_v2_instantiations_equal_plain_on_card(card, name):
    """The three V2 instantiations over the port's v2 rows (resolve words
    kid0, rel_ep1; a padded row at k63 and k65) equal their plain versions
    in every field: kernel 2 over the whole table, the lookup kernel (each
    launched, counted), and kernel 2's shard form, owned and packed, on
    three shards; and the v1 engine's ids."""
    idx = synthetic.small_index(name)
    eng, v1 = TorchEngine(idx, card, row_format="v2"), TorchEngine(idx, card)
    cfg, t = eng.cfg, eng.tables
    assert cfg.row_v2 and cfg.quad_w == 2
    q, _ = synthetic.query_batch(idx)
    kt = eng.kmers32(q)
    active = torch.from_numpy(np.random.default_rng(8).random(kt.shape[0]) < 0.9).to(card)
    args = _probe_args(cfg, kt)
    kernels.reset_counts()
    _equal(probe(cfg, t, kt, *args, active, "ids"), probe_plain(cfg, t, kt, *args, active, "ids"))
    got = E.lookup(cfg, t, kt, active, "ids")
    _equal(got, E.lookup_plain(cfg, t, kt, active, "ids"))
    counts = kernels.counts()
    assert counts["probe_kernel"] == 1 and counts["lookup_kernel"] == 1
    want = E.lookup(v1.cfg, v1.tables, kt, active, "ids")
    _equal(got, {key: want[key] for key in got})
    _shard_forms_equal_plain(cfg, t, kt, active, ("ids",), card)


def _cuts(n):
    """Uneven cuts of n >= 3 rows into three non-empty ranges."""
    a = max(1, n // 7)
    return [0, a, max(a + 1, n // 2), n]


def _combine(ts, op):
    """The shards' outputs ts combined by the mesh's unsigned pmin or pmax."""
    mesh = LocalMesh((1, len(ts)), ts[0].device)
    return getattr(mesh, op)({(0, j): t for j, t in enumerate(ts)}, "bucket",
                             unsigned=True)[(0, 0)]


def _equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


def _shard_forms_equal_plain(cfg, t, kt, active, forms, card):
    """Kernel 2's shard form on three shards cut unevenly (1/7, then to
    1/2, then the rest of the slots and heavy rows) equals its plain
    version in each field form of forms: the owned stores after every
    launch, over a sentinel, through both rounds of a regular lookup and
    the hand-off's passes, making the unsharded lookup's answer; the packed
    buffers, whose signed min is the unsharded kernel 2's."""
    sc = _cuts(t["cw_row"].shape[0])
    hc = _cuts(t["sk_hrows"].shape[0]) if cfg.has_skew else [0, 0, 0, 0]
    shards = [ProbeShard(a, b, c, d) for a, b, c, d in zip(sc, sc[1:], hc, hc[1:])]
    tabs = [dict(t, cw_row=t["cw_row"][s.slot_lo:s.slot_hi],
                 sk_hrows=t["sk_hrows"][s.hrow_lo:s.hrow_hi] if cfg.has_skew
                 else t["sk_hrows"]) for s in shards]
    rounds = shard_rounds(cfg, kt)
    B = kt.shape[0]
    for fields in forms:
        # the owned form: kernel and plain version each on its own result
        # tensors, equal after every launch; the lookup they make equals
        # the unsharded lookup's
        outs = [sentinel_result(fields, B, cfg.has_skew, card) for _ in range(2)]
        for args, rc in rounds:
            for n, (sh, tab) in enumerate(zip(shards, tabs)):
                for fn, out in zip((probe, probe_plain), outs):
                    fn(cfg, tab, *args, active, fields, sh, out=out, fill=n == 0 and not rc,
                       rc_round=rc, slots="read" if n else "store")
                _equal(*outs)
            if cfg.has_skew:
                assert (outs[0]["hrow"] != -1).any()
                for sh, tab in zip(shards, tabs):
                    for fn, out in zip((probe, probe_plain), outs):
                        fn(cfg, tab, *args, active, fields, sh, hrows=out["hrow"], out=out,
                           rc_round=rc)
                    _equal(*outs)
        outs[0].pop("hrow", None)
        outs[0].pop("slot")
        _equal(outs[0], E.lookup(cfg, t, kt, active, fields))
        # the packed form: every lane, a buffer a shard; their signed min is
        # the unsharded kernel 2's result
        args = rounds[0][0]
        bufs = []
        for sh, tab in zip(shards, tabs):
            pair = []
            for fn in (probe, probe_plain):
                out = {"packed": torch.full((packed_rows(fields), B), MARK, dtype=torch.int32,
                                            device=card)}
                if cfg.has_skew:
                    out["hrow"] = torch.full((B,), MARK, dtype=torch.int32, device=card)
                pair.append(fn(cfg, tab, *args, active, fields, sh, out=out))
            _equal(*pair)
            bufs.append(pair)
        if cfg.has_skew:
            hrow = _combine([b[0].pop("hrow") for b in bufs], "pmin")
            for (sh, tab), pair in zip(zip(shards, tabs), bufs):
                for fn, out in zip((probe, probe_plain), pair):
                    fn(cfg, tab, *args, None, fields, sh, hrows=hrow, out=out)
                pair[1].pop("hrow")
                _equal(*pair)
        want = probe(cfg, t, *args, active, fields)
        _equal(unpack_result(torch.stack([b[0]["packed"] for b in bufs]).amin(0), fields), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["m3_skew", "m3_skew_canonical", "m9_c1", "short_strings",
                                  "weighted", "k63", "k65", "k129_canonical"])
def test_sharded_kernels_equal_plain_on_card(card, name):
    """Kernel 2's shard form, access (both rounds), weight and the stream
    window read on three shards cut unevenly (1/7, then to 1/2, then the
    rest of the slots, heavy rows, id blocks, string words and weight
    runs): each kernel equals its plain version (kernel 2's owned stores
    after every launch, over a sentinel, through both rounds of a regular
    lookup and the hand-off's passes; its packed buffers), and the shards'
    answers combine to the unsharded kernels' (the owned stores to the
    lookup's; the chain given the combined windows equals the chain that
    reads strings32)."""
    idx = synthetic.small_index(name)
    eng = TorchEngine(idx, card)
    cfg, t = eng.cfg, eng.tables
    q, _ = synthetic.query_batch(idx)
    kt = eng.kmers32(q)
    active = torch.from_numpy(np.random.default_rng(6).random(kt.shape[0]) < 0.9).to(card)
    _shard_forms_equal_plain(cfg, t, kt, active, ("full", "ids"), card)
    # access: id blocks and string words cut unevenly, the strings' slices
    # with their halo
    ids = torch.arange(idx.num_kmers, dtype=torch.int32, device=card)
    bc, wc = _cuts(t["acc_rows"].shape[0]), _cuts(t["strings32"].shape[0])
    halo = cfg.W + 1
    ash = [AccessShard(a, b, c, d) for a, b, c, d in zip(bc, bc[1:], wc, wc[1:])]
    atabs = [dict(t, acc_rows=t["acc_rows"][s.blk_lo:s.blk_hi],
                  strings32=t["strings32"][s.word_lo:s.word_hi + halo]) for s in ash]
    firsts = []
    for sh, tab in zip(ash, atabs):
        got = E.access(cfg, tab, ids, sh)
        assert torch.equal(got, E.access_plain(cfg, tab, ids, sh))
        firsts.append(got)
    if firsts[0].dim() == 1:  # two-round form: offsets, then the word owners read
        off = _combine(firsts, "pmin")
        firsts = []
        for sh, tab in zip(ash, atabs):
            got = E.access_read(cfg, tab, off, sh)
            assert torch.equal(got, E.access_read_plain(cfg, tab, off, sh))
            firsts.append(got)
    assert torch.equal(_combine(firsts, "pmax"), E.access(cfg, t, ids))
    if cfg.weighted:
        ep = t["w_endpoints"]
        rc = _cuts(ep.shape[0] - 1)
        ws = []
        for a, b in zip(rc, rc[1:]):
            tab = dict(t, w_endpoints=ep[a:b + 1], w_value_ids=t["w_value_ids"][a:b])
            got = E.weight(tab, ids, owned=True)
            assert torch.equal(got, E.weight_plain(tab, ids, owned=True))
            ws.append(got)
        assert torch.equal(_combine(ws, "pmax"), E.weight(t, ids))
    if cfg.row_v2 or name == "short_strings":
        return
    # the stream window read and the chain given windows, on a real chunk's
    # chain inputs
    calls = []

    def chain(*a, **kw):
        calls.append(a)
        return ST.stream_chain(*a, **kw)

    ops = ST.KERNEL_OPS._replace(chain=chain)
    strings = synthetic.index_strings(idx)
    reads = synthetic.cut_reads(strings, 300, min(max(120, idx.k + 40), min(map(len, strings))),
                                np.random.default_rng(7), rc=0.5, subst=0.01)
    s = ST._DeviceStream(eng, idx.k, pmax=1 << 14)
    s.capture = []
    for r in reads:
        s.add_read(r)
    s.finalize()
    av, packed = s.capture[0]
    ST.make_stream_step(cfg, s.P, s.R, s.CW, E.make_lookup(cfg, "full"), all_valid=av,
                        ops=ops)(t, packed)
    ares, words32, strings32, *rest = calls[0]
    wins = []
    for sh, tab in zip(ash, atabs):
        got = ST.stream_swin(ares["kmer_offset"], ares["kmer_orientation"], tab["strings32"],
                             idx.k, sh)
        assert torch.equal(got, ST.stream_swin_plain(ares["kmer_offset"],
                                                     ares["kmer_orientation"], tab["strings32"],
                                                     idx.k, sh))
        wins.append(got)
    swin = _combine(wins, "pmax")
    want = ST.stream_chain(ares, words32, strings32, *rest)
    for fn in (ST.stream_chain, ST.stream_chain_plain):
        got = fn(ares, words32, None, *rest, swin=swin)
        found = want["found"] != 0
        assert torch.equal(got["found"], want["found"]) and torch.equal(got["need"], want["need"])
        for key in ("string_id", "kmer_id", "kmer_orientation"):
            assert torch.equal(got[key], want[key]), key
        assert found.any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("name", ["m13_regular", "m3_skew", "m3_skew_canonical", "partitioned",
                                  "k65_canonical", "k129_canonical"])
def test_owner_written_lookup_on_card(card, name, shape, monkeypatch):
    """The LocalMesh lookup on the card: result tensors filled with a
    sentinel, no lane keeps it, every field equals the unsharded engine's;
    the path launches kernel 1 once a data row and kernel 2's shard form
    once a shard, round and pass, and no combine but the report's sum over
    the data rows."""
    idx = synthetic.small_index(name)
    eng = ShardedEngine(idx, LocalMesh(shape, card))
    monkeypatch.setattr(eng, "_result_tensors",
                        lambda B, fields: sentinel_result(fields, B, eng.handoff, card))
    q, _ = synthetic.query_batch(idx)
    kt = eng.kmers32(q[: len(q) // 2 * 2])
    kernels.reset_counts()
    got = eng.lookup_device(kt)[0]
    c = kernels.counts()
    rounds = 1 if eng.cfg.canonical else 2
    assert c["minimizer_kernel"] == shape[0]
    assert c["probe_kernel"] == shape[0] * rounds * shape[1] * (2 if eng.handoff else 1)
    assert c["combine_kernel"] == (2 if shape[0] > 1 else 0)
    assert not (got["kmer_orientation"] == 7).any() and not (got["kmer_id"] == MARK).any()
    _equal(got, TorchEngine(idx, card).lookup_device(kt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("nb", [1, 2, 3, 8, 11])
def test_combine_kernel_equals_plain_on_card(card, dtype, nb):
    """The combine kernel against its plain version (a stack and a
    reduction): min and max signed and (int32) in u32 order with values at
    and above 2^31, wrapping sums; lengths around its 16-byte vectors,
    views that are not 16-byte aligned (the scalar loop), groups past its
    eight inputs (folded)."""
    rng = np.random.default_rng(nb)
    u32s = np.array([0, 1, 5, 0x7FFFFFFF, 1 << 31, 0x80000001, 0xFFFFFFFE, 0xFFFFFFFF],
                    dtype=np.uint32)
    for n in (1, 3, 4, 5, 1027, 1 << 16):
        if dtype == torch.int32:
            base = [torch.from_numpy(rng.choice(u32s, n + 1).view(np.int32).copy())
                    for _ in range(nb)]
        else:
            base = [torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, n + 1)) for _ in range(nb)]
        for ts in ([b[:n].to(card) for b in base], [b.to(card)[1:] for b in base]):
            for op in ("min", "max", "sum"):
                for unsigned in ((False, True) if dtype == torch.int32 and op != "sum"
                                 else (False,)):
                    before = kernels.combine_kernel.launches
                    got = kernels.combine_kernel(op, unsigned, *ts)
                    assert kernels.combine_kernel.launches - before == 1 + max(0, nb - 2) // 7
                    assert torch.equal(got, combine_plain(op, unsigned, *ts)), (n, op, unsigned)
                    assert torch.equal(combine(op, unsigned, *ts), got)


def _rows_equal(got, want):
    g, w = got.cpu().numpy().view(np.uint32), want.cpu().numpy().view(np.uint32)
    assert np.array_equal(g[0], w[0])
    for i in (1, 2):
        assert g[i, 0] == w[i, 0] and (not w[i, 0] or np.array_equal(g[i], w[i]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["m13_regular", "m13_canonical", "k15", "k63", "m3_skew",
                                  "k65", "k127_canonical", "k129_canonical"])
def test_stream_kernels_equal_plain_on_card(card, name, tmp_path):
    """The stream step through the four stream sources and kernels 1-2
    equals the plain step on every chunk, and the report equals the JAX
    package's host _Batcher (its oracle's lookups), for a genome, mixed
    reads and low-hit reads with Ns."""
    idx = synthetic.small_index(name)
    jdict = sshash_tpu.Dictionary(jax_index(idx, tmp_path))
    eng = TorchEngine(idx, card)
    rng = np.random.default_rng(3)
    plain = E.make_lookup(eng.cfg, "full", minimizer=P.minimizer_plain, probe=probe_plain)
    for path, ml in _stream_files(idx, rng, tmp_path).items():
        s = ST._DeviceStream(eng, idx.k, pmax=1 << 16, rmax_shift=12 if ml else 6)
        s.capture = []
        before = kernels.counts()
        for seq in ST.parse_reads(path, multiline=ml):
            s.add_read(seq)
        rep = s.finalize()
        after = kernels.counts()
        # every stream wrapper but the window read of a bucket-sharded stream
        assert all(after[n] > before[n] for src in ("scan.cu", "stream_anchor.cu",
                                                    "stream_chain.cu", "stream_derive.cu")
                   for n in kernels.SOURCE_KERNELS[src] if n != "stream_swin_kernel")
        want = jax_streaming.streaming_query_from_file(jdict, path, multiline=ml)
        assert rep == {key: want[key] for key in rep}
        for av, packed in s.capture:
            step = ST.make_stream_step(eng.cfg, s.P, s.R, s.CW, plain, all_valid=av,
                                       ops=ST.PLAIN_OPS)
            _rows_equal(s._steps[av](eng.tables, packed), step(eng.tables, packed))


def _stream_files(idx, rng, tmp_path):
    """A genome of the index's strings (multiline FASTA) and reads cut from
    them with RC and substitutions, plus random reads, with Ns (FASTQ).
    Returns {path: multiline}."""
    strings = synthetic.index_strings(idx)
    # reads hold kmers at every k (k + 37 and k + 13 chars past k = 63)
    L = min(max(100, idx.k + 37), max(len(s) for s in strings))
    reads = synthetic.cut_reads(strings, 600, L, rng, rc=0.5, subst=0.01)
    reads = synthetic.with_n(reads + synthetic.random_reads(600, max(76, idx.k + 13), rng), 0.02,
                             rng)
    genome, fq = os.path.join(tmp_path, "genome.fa"), os.path.join(tmp_path, "reads.fq")
    synthetic.write_genome(genome, strings * 2, rng)
    synthetic.write_reads(fq, reads)
    return {genome: True, fq: False}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["m13_regular", "m13_canonical"])
def test_stream_step_captures_in_a_cuda_graph(card, name, tmp_path):
    """The kernel step waits on nothing from the host: it captures in a
    CUDA graph, and each replay gives the step's (3, 4) on every chunk."""
    idx = synthetic.small_index(name)
    eng = TorchEngine(idx, card)
    for path, ml in _stream_files(idx, np.random.default_rng(4), tmp_path).items():
        s = ST._DeviceStream(eng, idx.k, pmax=1 << 16, rmax_shift=12 if ml else 6)
        s.capture = []
        for seq in ST.parse_reads(path, multiline=ml):
            s.add_read(seq)
        s.finalize()
        want = [s._steps[av](eng.tables, packed) for av, packed in s.capture]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            [s._steps[av](eng.tables, packed) for av, packed in s.capture]
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = [s._steps[av](eng.tables, packed) for av, packed in s.capture]
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("k,m", [(65, 25), (127, 31), (129, 31), (200, 13), (255, 31)])
def test_wide_minimizer_and_variants_equal_plain_on_card(card, k, m):
    """Kernel 1 (both strands and forward) and the neighbour variants at
    W = 5..16, fixed widths and the runtime-width form, on random kmers."""
    rng = np.random.default_rng(k)
    k32 = K.kmers_to_u32(synthetic.random_kmers(k, rng, 1 << 14), k)
    kt = torch.from_numpy(np.ascontiguousarray(k32).view(np.int32)).to(card)
    magic = int(rng.integers(0, 1 << 63))
    for both in (False, True):
        for g, w in zip(P.minimizer(kt, k, m, magic, both), P.minimizer_plain(kt, k, m, magic,
                                                                             both)):
            assert torch.equal(g, w)
    assert torch.equal(P.neighbour_variants(kt, k), P.neighbour_variants_plain(kt, k))


# k = 16w - 1 and 16w at every width w of 1..16 u32 words (k <= 255)
NEIGHBOUR_KS = [k for w in range(1, 17) for k in (16 * w - 1, 16 * w) if k <= 255]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 255, 257, 4099])
@pytest.mark.parametrize("k", NEIGHBOUR_KS)
def test_neighbours_kernel_equals_plain_at_every_width_on_card(card, k, B):
    """The neighbours kernels (four output words a thread where B*W is a
    multiple of 4, else one) at every width and at batch sizes around
    their blocks of 256 threads."""
    rng = np.random.default_rng(k * 10007 + B)
    k32 = K.kmers_to_u32(synthetic.random_kmers(k, rng, B), k)
    kt = torch.from_numpy(np.ascontiguousarray(k32).view(np.int32)).to(card)
    got = P.neighbour_variants(kt, k)
    assert got.shape == (8, B, (2 * k + 31) // 32)
    assert torch.equal(got, P.neighbour_variants_plain(kt, k))


def _weight_case(n_runs, card):
    """Synthetic weight tables of n_runs runs, their 4 shards (the JAX
    ShardedEngine's split) and ids at every endpoint, endpoint - 1 and + 1
    and at random, all on the card."""
    S = kernels.WEIGHT_SAMPLE
    span = 1000 if n_runs < 4 else 5_000_000 if n_runs < S - 1 else 1 << 31
    rng = np.random.default_rng(n_runs)
    host = synthetic.weight_tables(n_runs, span, rng)
    ep = host["w_endpoints"].astype(np.int64)
    ids = np.concatenate([[0, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1], ep, ep - 1, ep + 1,
                          rng.integers(0, 2 ** 32, 5000)]) % 2 ** 32
    on = lambda d: {key: torch.from_numpy(v.view(np.int32)).to(card)  # noqa: E731
                    for key, v in d.items()}
    eps, vids = split_weight_runs(host["w_endpoints"], host["w_value_ids"], 4)
    parts = [on({"w_endpoints": eps[j * (len(eps) // 4): (j + 1) * (len(eps) // 4)].copy(),
                 "w_value_ids": vids[j * (len(vids) // 4): (j + 1) * (len(vids) // 4)].copy(),
                 "w_dictionary": host["w_dictionary"]}) for j in range(4)]
    return on(host), parts, torch.from_numpy(ids.astype(np.uint32).view(np.int32)).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("n_runs", [1, 2, 4307, 16382, 16383, 16384, 1 << 20])
def test_weight_kernel_equals_plain_on_card(card, n_runs):
    """The weight kernel, unsharded and on each of 4 shards (owned), at run
    counts around the staged sample's capacity (fewer than
    kernels.WEIGHT_SAMPLE entries: the stride s goes from 1 to 2 at that
    many endpoints) and past it; its plan is the smallest stride that
    leaves fewer sample entries than that."""
    t, parts, ids = _weight_case(n_runs, card)
    assert torch.equal(E.weight(t, ids), E.weight_plain(t, ids))
    # the unsigned max over the shards is the unsharded weight below the
    # last endpoint
    combined = torch.zeros(ids.shape[0], dtype=torch.int64, device=card)
    for j, part in enumerate(parts):
        got = E.weight(part, ids, owned=True)
        assert torch.equal(got, E.weight_plain(part, ids, owned=True)), f"shard {j}"
        combined = torch.maximum(combined, got.to(torch.int64) & 0xFFFFFFFF)
    inside = (ids.to(torch.int64) & 0xFFFFFFFF) < int(t["w_endpoints"][-1]) & 0xFFFFFFFF
    want = E.weight_plain(t, ids).to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(combined[inside], want[inside])
    n_ep = t["w_endpoints"].shape[0]
    plan = kernels.weight_plan(n_ep, n_runs)
    S = kernels.WEIGHT_SAMPLE
    assert plan["ns"] == -(-n_ep // plan["s"]) < S
    assert plan["s"] == 1 or -(-n_ep // (plan["s"] // 2)) >= S
    assert plan["nb"] >= min(plan["ns"], 8192) and plan["per_sm"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["m13_regular", "m3_skew_canonical", "k63", "k65",
                                  "k129_canonical"])
def test_check_and_read_kernels_equal_plain_on_card(card, name):
    """The sanitizer's check kernel on the lookup's real fields (passing,
    and with shrunk bounds, failing), on v2 rows' id fields, and on
    fields with planted violations; the read kernel over the interleaved
    (NW, 2) table, offsets past the end included."""
    idx = synthetic.small_index(name)
    eng = TorchEngine(idx, card)
    q, _ = synthetic.query_batch(idx)
    res = eng.lookup_device(eng.kmers32(q))
    n = res["found"].shape[0]
    fields = [res[f] for f in ("found", "kmer_id", "kmer_orientation", "kmer_offset",
                               "string_begin")]
    bad_ori = res["kmer_orientation"].clone()
    bad_ori[::7] = 0
    bad_beg = res["string_begin"].clone()
    bad_beg[::5] = -1
    cases = [(fields, idx.num_kmers, idx.num_chars), (fields, 1, 1),
             (fields[:3] + [None, None], idx.num_kmers, 0),
             (fields[:2] + [bad_ori] + fields[3:], idx.num_kmers, idx.num_chars),
             (fields[:4] + [bad_beg], idx.num_kmers, idx.num_chars)]
    for args, nk, nc in cases:
        got = debug.check(*args, nk, nc)
        assert torch.equal(got, debug.check_plain(*args, nk, nc))
    assert debug.check(*fields, idx.num_kmers, idx.num_chars).tolist() == [0, 0, 0, 0]
    assert debug.check(*fields, 1, 1).tolist()[:2] == [1, 1]
    t = P.interleave_valid_starts(eng.tables["strings32"], eng.tables["vstart32"])
    rng = np.random.default_rng(7)
    offs = rng.integers(0, 16 * t.shape[0] + 64, n).astype(np.uint32)
    ot = torch.from_numpy(offs.view(np.int32)).to(card)
    for g, w in zip(P.read_kmers_at2(t, ot, idx.k), P.read_kmers_at2_plain(t, ot, idx.k)):
        assert torch.equal(g, w)


def _tile_sizes(tile):
    return [1, tile - 1, tile, tile + 1, 37 * tile + 5]


@pytest.mark.cuda
@pytest.mark.parametrize("n", _tile_sizes(kernels.SCAN_TILE))
def test_scan_kernel_equals_plain_on_card(card, n):
    """One-pass scan: sums that wrap 2^32, inputs that start 0-3 words off
    16 bytes; calls on one scratch (the C entry's memset resets its tile
    counter and status words between them) give each input's own sums."""
    rng = np.random.default_rng(n)
    v = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n + 3, dtype=np.int64)
                         .astype(np.int32)).to(card)
    before = kernels.counts()["scan_kernel"]
    for lo in (0, 1, 2, 3):
        x = v[lo:lo + n]
        assert torch.equal(P.scan_ex(x), P.prefix_sum_ex(x)), lo
    assert kernels.counts()["scan_kernel"] == before + 4
    lib = kernels.library()
    scratch = torch.empty(lib.sshash_scan_scratch(n, 0), dtype=torch.int64, device=card)
    for rep in range(3):
        x = v[rep:rep + n]
        out = torch.empty(n, dtype=torch.int32, device=card)
        assert lib.sshash_scan(x.data_ptr(), n, scratch.data_ptr(), out.data_ptr(),
                               kernels._stream(card)) == 0
        assert torch.equal(out, P.prefix_sum_ex(x)), rep


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["random", "all", "none", "sparse"])
@pytest.mark.parametrize("n", _tile_sizes(kernels.COMPACT_TILE))
def test_compact_kernel_equals_plain_on_card(card, n, fill):
    """One-pass compaction: any nonzero flag is set, the positions past the
    count are zeros (the kernel fills them over memory that held other
    values), flags that start 0-15 bytes off 16; repeated calls on one
    scratch."""
    rng = np.random.default_rng(n)
    f = {"random": rng.integers(0, 256, n + 15) * (rng.random(n + 15) < 0.3),
         "all": rng.integers(1, 256, n + 15), "none": np.zeros(n + 15),
         "sparse": rng.random(n + 15) < 1e-4}[fill]
    flags = torch.from_numpy(f.astype(np.uint8)).to(card)
    lib = kernels.library()
    scratch = torch.empty(lib.sshash_scan_scratch(n, 1), dtype=torch.int64, device=card)
    for lo in (0, 1, 7, 15):
        x = flags[lo:lo + n]
        want = P.compact_plain(x)
        got = P.compact(x)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), lo
        idx = torch.full((n,), -1, dtype=torch.int32, device=card)
        cnt = torch.full((1,), -1, dtype=torch.int32, device=card)
        assert lib.sshash_compact(x.data_ptr(), n, scratch.data_ptr(), idx.data_ptr(),
                                  cnt.data_ptr(), kernels._stream(card)) == 0
        assert torch.equal(idx, want[0]) and torch.equal(cnt, want[1]), lo


def _round2_case(case, Pn, rng):
    """head, found, minimizer_found (bool (Pn,)) and the count: heads below
    the count as stream_heads makes them (rank 0 whenever it is > 0),
    other values past it."""
    n = {"random": int(rng.integers(1, Pn)), "n0": 0, "n1": 1,
         "mid_tile": 3 * kernels.ROUND2_TILE + 77}.get(case, Pn)
    p = {"one_run": 0.0, "one_run_miss": 0.0, "all_heads": 1.1, "sparse": 1e-5}.get(case, 0.2)
    head = rng.random(Pn) < p
    head[n:] = rng.random(Pn - n) < 0.5
    head[0] |= n > 0
    found, mfound = rng.random(Pn) < 0.3, rng.random(Pn) < 0.5
    if case.startswith("one_run"):
        found[0], mfound[0] = False, case == "one_run"
    return head, found, mfound, n


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "one_run", "one_run_miss", "n0", "n1", "nP",
                                  "all_heads", "sparse", "mid_tile"])
def test_round2_kernel_equals_plain_on_card(card, case):
    """The copy-forward over 64 tiles: a run over every rank (its head
    finding its minimizer and not), no ranks, one, every rank a head, runs
    that span tiles; repeated calls on one scratch."""
    Pn = 1 << 20
    rng = np.random.default_rng(len(case))
    head, found, mfound, n = (torch.from_numpy(x).to(card) if isinstance(x, np.ndarray) else x
                              for x in _round2_case(case, Pn, rng))
    count = torch.tensor([n], dtype=torch.int32, device=card)
    want = ST.stream_round2_plain(head, found, mfound, count)
    got = ST.stream_round2(head, found, mfound, count)
    assert got.dtype == torch.bool and torch.equal(got, want)
    if case == "one_run":
        assert int(got.sum()) == Pn - 1
    lib = kernels.library()
    scratch = torch.empty(lib.sshash_round2_scratch(Pn), dtype=torch.int64, device=card)
    for shift in (0, 1, 2):
        h = torch.roll(head, 16 * shift)
        h[0] |= n > 0
        out = torch.ones(Pn, dtype=torch.bool, device=card)
        assert lib.sshash_stream_round2(h.data_ptr(), found.data_ptr(), mfound.data_ptr(),
                                        count.data_ptr(), Pn, scratch.data_ptr(),
                                        out.data_ptr(), kernels._stream(card)) == 0
        assert torch.equal(out, ST.stream_round2_plain(h, found, mfound, count)), shift


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [-1, 0, 1])
def test_heads_and_count_kernels_equal_plain_on_card(card, gate):
    """Heads over runs of equal minimizer pairs on consecutive lanes, at
    counts around the gate's P/64, 0 and P; the count kernel at lane counts
    that are no multiple of 16 and on fields that start off 16 bytes (a
    sharded engine's rows), as well as the step's."""
    Pn = 1 << 16
    rng = np.random.default_rng(gate + 1)
    # increasing lanes below P, mostly consecutive
    lanes = (np.minimum(np.cumsum(1 + (rng.random(Pn) < 0.02)), Pn) - 1).astype(np.int32)
    run = np.cumsum(rng.random(Pn) < 0.05)
    mv = [torch.from_numpy(run * 7919 + k).to(card) for k in (1, 2)]
    lt = torch.from_numpy(lanes).to(card)
    fbits = torch.from_numpy(rng.integers(0, 1 << 32, Pn // 32 + 1, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32) & 0x01010101).to(card)
    for n in (0, 1, Pn // 64, Pn // 64 + 1, Pn // 2 + 3, Pn):
        count = torch.tensor([n], dtype=torch.int32, device=card)
        got = ST.stream_heads(mv[0], mv[1], lt, count, fbits, gate)
        want = ST.stream_heads_plain(mv[0], mv[1], lt, count, fbits, gate)
        assert got.dtype == torch.bool and torch.equal(got, want), n
    for L, off in ((Pn, 0), (Pn - 5, 0), (1000, 1), (17, 3), (1, 2)):
        st = {"found": torch.from_numpy((rng.random(L + off) < 0.7).astype(np.uint8)).to(card)}
        kid = np.cumsum(rng.integers(0, 2, L + off)).astype(np.int32)
        st["kmer_id"] = torch.from_numpy(kid).to(card)
        st["string_id"] = torch.from_numpy(kid // 50).to(card)
        st["kmer_orientation"] = torch.from_numpy(
            np.where(rng.random(L + off) < 0.9, 1, -1).astype(np.int32)).to(card)
        st = {key: v[off:] for key, v in st.items()}
        vb = torch.from_numpy(rng.integers(0, 1 << 32, L // 32 + 1, dtype=np.uint64)
                              .astype(np.uint32).view(np.int32) | 0x7FFFFFF7).to(card)
        for cnt in (0, 1, L):
            count = torch.tensor([cnt], dtype=torch.int32, device=card)
            got = ST.stream_count(st, vb, fbits[: L // 32 + 1].contiguous(), count)
            want = ST.stream_count_plain(st, vb, fbits[: L // 32 + 1].contiguous(), count)
            assert torch.equal(got, want), (L, off, cnt)


def test_wrappers_take_cuda_tensors_only():
    idx = synthetic.small_index("m9_c1")
    eng = TorchEngine(idx, "cpu")
    cfg = eng.cfg
    kt = torch.zeros((4, cfg.W), dtype=torch.int32)
    before = kernels.counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.minimizer_kernel(kt, cfg.k, cfg.m, cfg.magic)
    mv = torch.zeros(4, dtype=torch.int64)
    mp = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.probe_kernel(cfg, eng.tables, kt, None, mv, mp)
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.access_kernel(cfg, eng.tables, ids)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.iterate_kernel(cfg.k, eng.tables["strings32"], eng.tables["vstart32"])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.weight_kernel(eng.tables, ids)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.neighbours_kernel(kt, cfg.k)
    v = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.scan_kernel(v)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.compact_kernel(v.to(torch.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stream_anchors_kernel(v, torch.zeros(3, dtype=torch.int32),
                                      torch.zeros(1, dtype=torch.int32), v, 64, cfg.k)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stream_kmers_kernel(v, torch.zeros(3, dtype=torch.int32),
                                    torch.zeros(4, dtype=torch.int32), cfg.k, mp, mp[:1])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stream_heads_kernel(mv, mv, mp, mp[:1], mp[:1], -1)
    flags = torch.zeros(64, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stream_round2_kernel(flags, flags, flags, mp[:1])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.access_read_kernel(cfg, eng.tables, ids, AccessShard(0, 1, 0, 1))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stream_swin_kernel(ids, ids, eng.tables["strings32"], cfg.k,
                                   AccessShard(0, 1, 0, 1))
    found = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.check_kernel(found, ids, ids, ids, ids, 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.read_at2_kernel(torch.zeros((4, 2), dtype=torch.int32), ids, cfg.k)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.combine_kernel("min", True, ids, ids)
    assert kernels.counts() == before
    meta = torch.empty((4, cfg.W), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="minimizer"):
        P.minimizer(meta, cfg.k, cfg.m, cfg.magic)
    with pytest.raises(ValueError, match="probe"):
        probe(cfg, eng.tables, meta, None, mv, mp)
    mv = torch.empty(64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="scan"):
        P.scan_ex(mv)
    with pytest.raises(ValueError, match="compaction"):
        P.compact(mv)
    with pytest.raises(ValueError, match="anchors"):
        ST.stream_anchors(mv, mv, mv, mv, 64, cfg.k)
    with pytest.raises(ValueError, match="kmer-read"):
        ST.stream_kmers(mv, mv, mv, cfg.k, mv, mv[:1])


ENTRIES = {"minimizer": (P.minimizer, 0), "neighbours": (P.neighbour_variants, 0),
           "scan": (P.scan_ex, 0), "compaction": (P.compact, 0), "probe": (E.probe, 2),
           "access": (E.access, 2), "access-read": (E.access_read, 2),
           "iterator": (E.iterate, 1), "weight": (E.weight, 1), "window": (ST.stream_swin, 0),
           "anchors": (ST.stream_anchors, 0), "kmer-read": (ST.stream_kmers, 0),
           "chain": (ST.stream_chain, 1), "run-skip": (ST.stream_heads, 2),
           "round-2": (ST.stream_round2, 0), "merge": (ST.stream_merge, 0),
           "count": (ST.stream_count, 1), "check": (debug.check, 0),
           "read-at2": (P.read_kmers_at2, 1), "combine": (combine, 2)}


@pytest.mark.parametrize("what", sorted(ENTRIES))
def test_entry_dispatches_on_its_tensor_argument(what):
    """Each entry point reads the device of its own tensor argument and
    raises, naming its kernel, on a device with neither a kernel nor a
    plain version."""
    entry, arg = ENTRIES[what]
    args = [None] * (arg + 1)
    args[arg] = torch.empty(4, device="meta")
    before = kernels.counts()
    with pytest.raises(ValueError, match=f"no {what} kernel for device meta"):
        entry(*args)
    assert kernels.counts() == before


def test_library_name_tracks_sources():
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libsshash_tpu_torch_") and path.suffix == ".so"
    assert path == kernels.library_path()
