"""The bucket-sharded stream's lookups in rank space: kernel 2's rank form
(engine.probe_ranks: csrc/shard.cuh, entry sshash_probe_ranks) on each shard of a
data row, after kernel 1's rank form, for ShardedStream's missed lanes and
anchors. Its plain version against the masked owned lookup it replaces
(the lane form over all P lanes) below the count, in the owned and the
packed form; the sharded step against the unsharded port step on the same
packed chunks; ShardedStream against the JAX package's ShardedStream and
the host _Batcher; and, on a card, the kernel against its plain version.

The same seeded inputs go through every side. Outputs are integers: the
tolerance is 0. JAX and the JAX package are imported inside the CPU
tests only, so a machine with a card and no JAX runs the card test
(tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_shard_stream_ranks.py
"""

import functools

import numpy as np
import pytest
import torch

from sshash_tpu_torch import TorchEngine, kernels, oracle, synthetic
from sshash_tpu_torch import engine as E
from sshash_tpu_torch import kmer as K
from sshash_tpu_torch import streaming as ST
from sshash_tpu_torch.engine import probe_ranks, probe_ranks_plain, unpack_result
from sshash_tpu_torch.layout import packed_rows
from sshash_tpu_torch.ops import packed as P
from sshash_tpu_torch.parallel import LocalMesh, ShardedEngine, ShardedStream
from sshash_tpu_torch.parallel.mesh import combine_plain

P_RANKS = 256
# no rank, one, a count no multiple of 32, every rank
COUNTS = (0, 1, 45, P_RANKS)
SHAPES = ((1, 2), (1, 4), (2, 2))
# regular, canonical, and an hindex index whose heavy lanes' rows another
# shard holds (the hand-off)
NAMES = ("m13_regular", "m13_canonical", "m3_skew")
MARK = 0x5A5A5A5A  # a sentinel no result field holds
CHUNK = 1 << 11  # ShardedStream's positions a chunk


@functools.lru_cache(maxsize=None)
def index(name):
    return synthetic.small_index(name)


def sentinel(fields, B, handoff, device="cpu", packed=False):
    """The rank form's output holding a sentinel: the owned form's result
    tensors (ids MARK, orientation 7) and the lanes' slots, or a packed
    buffer, plus the hand-off's rows."""
    if packed:
        out = {"packed": torch.full((packed_rows(fields), B), MARK, dtype=torch.int32,
                                    device=device)}
    else:
        out = {name: torch.full((B,), MARK, dtype=dt, device=device) if dt == torch.int32
               else torch.zeros(B, dtype=dt, device=device)
               for name, dt in kernels.result_dtypes(fields).items()}
        out["kmer_orientation"].fill_(7)
        out["slot"] = torch.full((B,), MARK, dtype=torch.int32, device=device)
    if handoff:
        out["hrow"] = torch.full((B,), MARK, dtype=torch.int32, device=device)
    return out


def rank_batch(eng, seed, device="cpu"):
    """P_RANKS kmers compacted in rank order: positives (half
    reverse-complemented, a third of them in multi-kmer or heavy buckets)
    and random kmers, shuffled; an active mask of about 70% of them; kernel
    1's rank-form minimizers of every rank."""
    idx, cfg = eng.index, eng.cfg
    rng = np.random.default_rng(seed)
    n_pos = P_RANKS * 3 // 4
    ids = np.concatenate([rng.integers(0, idx.num_kmers, n_pos - n_pos // 3),
                          synthetic.path_kmer_ids(idx, rng, n_pos // 3)])
    km = oracle.access(idx, ids)
    km[::2] = K.revcomp_kmers(km[::2], idx.k)
    km = np.concatenate([km, synthetic.random_kmers(idx.k, rng, P_RANKS - len(km))])
    kt = eng.kmers32(km[rng.permutation(P_RANKS)]).to(device)
    active = torch.from_numpy(rng.random(P_RANKS) < 0.7).to(device)
    full = torch.tensor([P_RANKS], dtype=torch.int32, device=device)
    return kt, active, P.minimizer_ranks(kt, full, cfg.k, cfg.m, cfg.magic)


def count_of(n, device="cpu"):
    return torch.tensor([n], dtype=torch.int32, device=device)


def packed_rank_lookup(eng, row, kt, mins, active, count):
    """The DistMesh rank-space lookup's plain version on a LocalMesh's
    shards: each shard's packed buffer, the hand-off's rows and the buffers
    combined by min (mesh.combine_plain), in regular mode the RC round
    after them merged by engine.merge_rc (parallel/sharded.py
    _packed_ranks, with the collectives taken over the shards at once)."""
    cfg, shards = eng.cfg, [s[1] for s in eng._row_shards(row)]

    def one_round(act, rc_round):
        outs = [sentinel("full", P_RANKS, eng.handoff, packed=True) for _ in shards]
        for j, out in zip(shards, outs):
            probe_ranks_plain(cfg, eng.tables[j], kt, mins, act, count, "full",
                              eng.probe_shards[j], out, rc_round=rc_round)
        if eng.handoff:
            hrow = combine_plain("min", True, *(o.pop("hrow") for o in outs))
            for j, out in zip(shards, outs):
                probe_ranks_plain(cfg, eng.tables[j], kt, mins, act, count, "full",
                                  eng.probe_shards[j], out, rc_round=rc_round, hrows=hrow)
        return unpack_result(combine_plain("min", False, *(o["packed"] for o in outs)), "full")

    res = one_round(active, False)
    if not cfg.canonical:
        miss = E.rc_misses(res, active)
        res = E.merge_rc(res, one_round(miss, True), miss)
    return res


@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_rank_form_equals_the_masked_owned_lookup(name, shape, count, monkeypatch):
    """On each data row: the rank form (the misses' stream fields, an
    active mask; the anchors' full fields, every rank) equals the lane
    form's masked owned lookup over the ranks below the count, field by
    field, in the owned and the packed form; no rank at or past the count
    is written (the result tensors hold a sentinel before)."""
    eng = ShardedEngine(index(name), LocalMesh(shape, "cpu"))
    cfg = eng.cfg
    assert eng.handoff == (name == "m3_skew")
    kt, active, mins = rank_batch(eng, 7)
    cnt = count_of(count)
    monkeypatch.setattr(eng, "_result_tensors",
                        lambda B, fields: sentinel(fields, B, eng.handoff))
    for row in eng.mesh.rows:
        for fields, act in (("stream", active), ("full", None)):
            got = eng._ranks_fn(row, fields)(cfg, None, kt, mins, act, cnt)
            assert set(got) == set(kernels.result_dtypes(fields))
            assert (got["kmer_orientation"][count:] == 7).all()
            assert (got["kmer_id"][count:] == MARK).all() and not got["found"][count:].any()
            if count == 0:
                continue
            want = eng._lookup_fn(row, "full")(None, kt[:count],
                                               None if act is None else act[:count])
            assert not (got["kmer_orientation"][:count] == 7).any()
            for key, v in got.items():
                assert torch.equal(v[:count], want[key]), (fields, key)
            pk = packed_rank_lookup(eng, row, kt, mins, act, cnt)
            for key, v in want.items():
                assert torch.equal(pk[key][:count], v), ("packed", fields, key)
    if count == P_RANKS:  # found and missed lanes, both orientations; at m13
        # lanes whose minimizer is in no bucket (at m3 every m-mer is)
        res = eng._lookup_fn(eng.mesh.rows[0], "full")(None, kt, active)
        assert res["found"].any() and (active & ~res["found"]).any()
        assert (res["kmer_orientation"] == -1).any() and (res["kmer_orientation"] == 1).any()
        assert (~res["minimizer_found"]).any() == (cfg.m > 3)


def test_rank_form_raises_on_what_it_does_not_take():
    """The rank wrapper takes CUDA tensors only (nothing launches on a CPU
    tensor), v1 rows only, the stream's fields in the owned form only, and
    rc_round in regular mode only."""
    idx = index("m13_regular")
    eng = ShardedEngine(idx, LocalMesh((1, 2), "cpu"))
    cfg, sh = eng.cfg, eng.probe_shards[0]
    kt, active, mins = rank_batch(eng, 3)
    before = kernels.counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.probe_ranks_kernel(cfg, eng.tables[0], kt, mins, active, count_of(3), "stream",
                                   sh, sentinel("stream", P_RANKS, False))
    assert kernels.counts() == before
    with pytest.raises(ValueError, match="full fields"):
        probe_ranks(cfg, eng.tables[0], kt, mins, active, count_of(3), "stream", sh,
                    sentinel("full", P_RANKS, False, packed=True))
    with pytest.raises(ValueError, match="fields"):
        probe_ranks(cfg, eng.tables[0], kt, mins, active, count_of(3), "ids", sh,
                    sentinel("ids", P_RANKS, False))
    with pytest.raises(ValueError, match="shard form"):
        probe_ranks(cfg, eng.tables[0], kt, mins, active, count_of(3), "stream", None,
                    sentinel("stream", P_RANKS, False))
    ceng = ShardedEngine(index("m13_canonical"), LocalMesh((1, 2), "cpu"))
    with pytest.raises(ValueError, match="RC round"):
        probe_ranks(ceng.cfg, ceng.tables[0], kt, mins, active, count_of(3), "stream",
                    ceng.probe_shards[0], sentinel("stream", P_RANKS, False), rc_round=True)
    v2 = ShardedEngine(idx, LocalMesh((1, 2), "cpu"), row_format="v2")
    with pytest.raises(ValueError, match="v1 rows"):
        probe_ranks(v2.cfg, v2.tables[0], kt, mins, active, count_of(3), "stream",
                    v2.probe_shards[0], sentinel("stream", P_RANKS, False))


def stream_reads(idx, rng, path, n_index=200, n_random=200):
    """Reads cut from the index (half RC, 1% substitutions) and random
    reads, with Ns: every path of the misses (FASTQ at path)."""
    strings = synthetic.index_strings(idx)
    L = min(max(100, idx.k + 37), max(len(s) for s in strings))
    reads = synthetic.cut_reads(strings, n_index, L, rng, rc=0.5, subst=0.01)
    reads += synthetic.random_reads(n_random, max(76, idx.k + 13), rng)
    synthetic.write_reads(path, synthetic.with_n(reads, 0.02, rng))
    return path


def run_stream(eng, path, multiline=False, capture=False):
    st = ShardedStream(eng, pmax=CHUNK, rmax_shift=4)
    if capture:
        st.capture = []
    for seq in ST.parse_reads(path, multiline=multiline):
        st.add_read(seq)
    return st.finalize(), st


def lane_forms_refused(monkeypatch):
    """Kernel 1's and kernel 2's lane forms raise when called: a stream run
    inside shows that it reached neither (the rank forms carry it)."""

    def refused(*a, **kw):
        raise AssertionError("the bucket-sharded stream ran a lane form")

    for entry in (P.minimizer, E.probe):
        monkeypatch.setattr(entry, "plain", refused)
        monkeypatch.setattr(entry, "kernel", refused)


@pytest.mark.parametrize("name,shape", [(n, s) for n in NAMES for s in SHAPES]
                         + [("k65", (1, 4))], ids=str)
def test_sharded_step_equals_the_unsharded_step(name, shape, tmp_path, monkeypatch):
    """ShardedStream over reads cut from the index and random reads runs no
    lane form of kernel 1 or 2 and equals the host _Batcher; each of its
    chunks through each data row's step gives the unsharded port step's
    (3, 4) counters and the same stats (misses, lookup heads, round-2
    ranks)."""
    idx = index(name)
    eng = ShardedEngine(idx, LocalMesh(shape, "cpu"))
    # at m3 every minimizer has a bucket, most of them long: fewer reads
    n = 20 if name == "m3_skew" else 60
    path = stream_reads(idx, np.random.default_rng(11), str(tmp_path / "reads.fq"), n, n)
    with monkeypatch.context() as m:
        lane_forms_refused(m)
        rep, st = run_stream(eng, path, capture=True)
    assert rep == ST.host_report(idx, path)
    assert st.chunks >= 2
    ref = TorchEngine(idx, "cpu")
    steps = {av: ST.make_stream_step(ref.cfg, st.P, st.R, st.CW, E.make_lookup(ref.cfg, "full"),
                                     all_valid=av) for av in (False, True)}
    rows, needed = eng.mesh.rows, 0
    for i, (av, packed) in enumerate(st.capture):
        got_stats, want_stats = {}, {}
        got = st._steps[(rows[i % len(rows)], av)](None, packed, got_stats)
        want = steps[av](ref.tables, packed, want_stats)
        assert torch.equal(got, want), i
        assert {key: int(v) for key, v in got_stats.items()} == \
               {key: int(v) for key, v in want_stats.items()}, i
        needed += int(got_stats["need"])
    assert needed > 0


def test_sharded_step_runs_no_lane_form(tmp_path, monkeypatch):
    """The misses of a regular and of a canonical sharded step reach only
    the rank forms: the stream's two lookup rounds each launch (here: run
    the plain version of) kernel 2's rank form once a shard and round (and
    hand-off pass), the anchors' lookup once a shard and round."""
    for name, shape in (("m13_regular", (1, 2)), ("m13_canonical", (1, 4))):
        idx = index(name)
        eng = ShardedEngine(idx, LocalMesh(shape, "cpu"))
        path = stream_reads(idx, np.random.default_rng(12), str(tmp_path / f"{name}.fq"),
                            n_index=40, n_random=20)
        calls = []
        plain = E.probe_ranks.plain
        with monkeypatch.context() as m:
            lane_forms_refused(m)
            m.setattr(E.probe_ranks, "plain",
                      lambda *a, **kw: calls.append(a[6]) or plain(*a, **kw))
            rep, st = run_stream(eng, path)
        assert rep == ST.host_report(idx, path)
        rounds = 1 if eng.cfg.canonical else 2
        per_chunk = 3 * rounds * shape[1]  # the anchors and the two lookups over the misses
        assert len(calls) == st.chunks * per_chunk
        assert calls.count("full") == st.chunks * rounds * shape[1]


def jax_stream_report(jeng, path, multiline):
    """The report of the JAX package's ShardedStream on jeng (a JAX
    ShardedEngine on the virtual CPU mesh of tests/conftest.py, which keeps
    the step it compiles for a chunk shape) over the file."""
    from sshash_tpu.parallel import ShardedStream as JaxShardedStream

    st = JaxShardedStream(jeng, pmax=CHUNK, rmax_shift=4)
    for seq in ST.parse_reads(path, multiline=multiline):
        st.add_read(seq)
    return st.finalize()


def read_sets(idx, rng, tmp_path):
    """{name: (path, multiline)}: low-hit reads (a few cut from the index,
    most random, 1% with an N), mixed reads (half cut with RC and
    substitutions, half random) and the index's strings as one genome
    record (every other one reverse-complemented)."""
    strings = synthetic.index_strings(idx)
    L = min(max(76, idx.k + 13), max(len(s) for s in strings))
    out = {}
    low = synthetic.cut_reads(strings, 10, L, rng) + synthetic.random_reads(300, L, rng)
    out["low-hit"] = (str(tmp_path / "low.fq"), False)
    synthetic.write_reads(out["low-hit"][0], synthetic.with_n(low, 0.01, rng))
    mixed = (synthetic.cut_reads(strings, 150, L, rng, rc=0.5, subst=0.01)
             + synthetic.random_reads(150, L, rng))
    out["mixed"] = (str(tmp_path / "mixed.fq"), False)
    synthetic.write_reads(out["mixed"][0], mixed)
    out["genome"] = (str(tmp_path / "genome.fa"), True)
    synthetic.write_genome(out["genome"][0], [synthetic.revcomp_bytes(s) if i % 2 else s
                                              for i, s in enumerate(strings)], rng)
    return out


@pytest.mark.parametrize("name", ["m13_canonical", "k65"])
def test_sharded_stream_equals_jax_and_the_batcher(name, tmp_path):
    """ShardedStream's reports on low-hit, mixed and genome reads, at k31
    (canonical) and k65 (regular), at (1, 2), (1, 4) and (2, 2), equal the
    JAX package's ShardedStream's (one compiled step a configuration) and
    the host _Batcher's."""
    from sshash_tpu.parallel import ShardedEngine as JaxShardedEngine
    from test_torch_host import jax_index
    from test_torch_sharded import jax_mesh

    idx = index(name)
    jeng = JaxShardedEngine(jax_index(idx), jax_mesh((1, 2)))
    sets = read_sets(idx, np.random.default_rng(13), tmp_path)
    for what, (path, ml) in sets.items():
        want = ST.host_report(idx, path, multiline=ml)
        assert want["num_positive_kmers"] > 0 and want["num_negative_kmers"] > 0
        assert jax_stream_report(jeng, path, ml) == want, what
        for shape in SHAPES:
            rep, st = run_stream(ShardedEngine(idx, LocalMesh(shape, "cpu")), path, ml)
            assert rep == want, (what, shape)


# ------------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["m13_regular", "m13_canonical", "m3_skew",
                                  "m3_skew_canonical", "partitioned", "k65", "k65_canonical",
                                  "k129_canonical"])
def test_rank_form_kernel_equals_plain_on_card(card, name, tmp_path):
    """Kernel 2's rank form on every shard of a (1, 3) mesh against its
    plain version: the owned stores (stream and full fields) after every
    launch over a sentinel, through both rounds and the hand-off's passes,
    and the packed buffers, at every count, nothing written at or past the
    count; then ShardedStream on the card launches kernel 1's and kernel
    2's rank forms and neither lane form, equals the host _Batcher, and its
    step captured in a CUDA graph replays to the same counters."""
    idx = index(name)
    eng = ShardedEngine(idx, LocalMesh((1, 3), card))
    cfg = eng.cfg
    kt, active, mins = rank_batch(eng, 5, card)
    for count in COUNTS:
        cnt = count_of(count, card)
        for fields, act in (("stream", active), ("full", None)):
            outs = [sentinel(fields, P_RANKS, eng.handoff, card) for _ in range(2)]
            for rc in (False,) if cfg.canonical else (False, True):
                for j, sh in enumerate(eng.probe_shards):
                    for fn, out in zip((probe_ranks, probe_ranks_plain), outs):
                        fn(cfg, eng.tables[j], kt, mins, act, cnt, fields, sh, out,
                           fill=j == 0 and not rc, rc_round=rc, slots="read" if j else "store")
                    _equal(outs, (name, count, fields, rc, j))
                if eng.handoff:
                    for j, sh in enumerate(eng.probe_shards):
                        for fn, out in zip((probe_ranks, probe_ranks_plain), outs):
                            fn(cfg, eng.tables[j], kt, mins, act, cnt, fields, sh, out,
                               rc_round=rc, hrows=out["hrow"])
                        _equal(outs, (name, count, fields, rc, j, "second pass"))
            assert (outs[0]["kmer_id"][count:] == MARK).all()
        for rc in (False,) if cfg.canonical else (False, True):
            for j, sh in enumerate(eng.probe_shards):
                pair = [fn(cfg, eng.tables[j], kt, mins, active, cnt, "full", sh,
                           sentinel("full", P_RANKS, eng.handoff, card, packed=True),
                           rc_round=rc) for fn in (probe_ranks, probe_ranks_plain)]
                _equal(pair, (name, count, "packed", rc, j))
                assert (pair[0]["packed"][:, count:] == MARK).all()
    if name in ("partitioned", "k129_canonical"):
        return
    path = stream_reads(idx, np.random.default_rng(11), str(tmp_path / "reads.fq"))
    kernels.reset_counts()
    rep, st = run_stream(eng, path, capture=True)
    c = kernels.counts()
    assert rep == ST.host_report(idx, path)
    assert c["minimizer_kernel"] == 0 and c["probe_kernel"] == 0
    assert c["minimizer_ranks_kernel"] > 0 and c["probe_ranks_kernel"] > 0
    av, packed = st.capture[0]
    step = st._steps[(0, av)]
    want = step(None, packed)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = step(None, packed)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _equal(pair, what):
    a, b = pair
    assert a.keys() == b.keys(), what
    for key in a:
        assert torch.equal(a[key], b[key]), (what, key)
