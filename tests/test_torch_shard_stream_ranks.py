"""The bucket-sharded stream's lookups in rank space: kernel 2's rank form
(csrc/shard.cuh: the list pass, engine.rank_lists, entry sshash_rank_lists,
once a data row; the list probe, engine.probe_ranks, entry
sshash_probe_ranks, over the row's shards), after kernel 1's rank form,
for ShardedStream's missed lanes and anchors. Its plain versions against
the masked owned lookup it replaces (the lane form over all P lanes) below
the count, in the owned and the packed form; the list pass's plain
version against the JAX package's MPHF slots (every active rank in the
list of its owner's keys, with its slot); the sharded step against the
unsharded port step on the same packed chunks; ShardedStream against the
JAX package's ShardedStream and the host _Batcher, also on a row of more
shards than one list probe launch serves; and, on a card, the kernels
against their plain versions.

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
from sshash_tpu_torch.engine import (probe_ranks, probe_ranks_plain, rank_lists,
                                     rank_lists_plain, unpack_result)
from sshash_tpu_torch.layout import MAX_ROW_SHARDS, ProbeShard, packed_rows
from sshash_tpu_torch.ops import packed as P
from sshash_tpu_torch.parallel import LocalMesh, ShardedEngine, ShardedStream
from sshash_tpu_torch.parallel.mesh import combine_plain
from one_thread import one_torch_thread  # noqa: F401

P_RANKS = 256
# no rank, one, a count no multiple of 32, every rank
COUNTS = (0, 1, 45, P_RANKS)
# the list pass's and the list probe's edges: a warp, one rank either side
LIST_COUNTS = (0, 1, 31, 32, 33, 45, P_RANKS)
M32 = 0xFFFFFFFF
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


def rank_batch(eng, seed, device="cpu", n=P_RANKS):
    """n kmers compacted in rank order: positives (half
    reverse-complemented, a third of them in multi-kmer or heavy buckets)
    and random kmers, shuffled; an active mask of about 70% of them; kernel
    1's rank-form minimizers of every rank."""
    idx, cfg = eng.index, eng.cfg
    rng = np.random.default_rng(seed)
    n_pos = n * 3 // 4
    ids = np.concatenate([rng.integers(0, idx.num_kmers, n_pos - n_pos // 3),
                          synthetic.path_kmer_ids(idx, rng, n_pos // 3)])
    km = oracle.access(idx, ids)
    km[::2] = K.revcomp_kmers(km[::2], idx.k)
    km = np.concatenate([km, synthetic.random_kmers(idx.k, rng, n - len(km))])
    kt = eng.kmers32(km[rng.permutation(n)]).to(device)
    active = torch.from_numpy(rng.random(n) < 0.7).to(device)
    full = torch.tensor([n], dtype=torch.int32, device=device)
    return kt, active, P.minimizer_ranks(kt, full, cfg.k, cfg.m, cfg.magic)


def count_of(n, device="cpu"):
    return torch.tensor([n], dtype=torch.int32, device=device)


def list_and_probe(kernel, cfg, tables, kt, mins, act, cnt, fields, shard, out, fill=False,
                   **kw):
    """One pass of the rank form on one shard: the list pass over its keys,
    then the list probe of that list; the kernels (kernel) or their plain
    versions. Returns out."""
    lists_fn, probe_fn = (rank_lists, probe_ranks) if kernel else (rank_lists_plain,
                                                                   probe_ranks_plain)
    lists = lists_fn(cfg, tables, kt, mins, act, cnt, fields, shard, out, fill=fill, **kw)
    return probe_fn(cfg, tables, kt, mins, act, cnt, fields, shard, out, lists=lists, **kw)


def packed_rank_lookup(eng, row, kt, mins, active, count):
    """The DistMesh rank-space lookup's plain version on a LocalMesh's
    shards: each shard's packed buffer (its list pass, then its list
    probe), the hand-off's rows and the buffers combined by min
    (mesh.combine_plain), in regular mode the RC round after them merged by
    engine.merge_rc (parallel/sharded.py _packed_ranks, with the
    collectives taken over the shards at once)."""
    cfg, shards = eng.cfg, [s[1] for s in eng._row_shards(row)]

    def one_round(act, rc_round):
        outs = [sentinel("full", P_RANKS, eng.handoff, packed=True) for _ in shards]
        for j, out in zip(shards, outs):
            list_and_probe(False, cfg, eng.tables[j], kt, mins, act, count, "full",
                           eng.probe_shards[j], out, rc_round=rc_round)
        if eng.handoff:
            hrow = combine_plain("min", True, *(o.pop("hrow") for o in outs))
            for j, out in zip(shards, outs):
                list_and_probe(False, cfg, eng.tables[j], kt, mins, act, count, "full",
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
    lists = {"entries": torch.zeros((P_RANKS, 2), dtype=torch.int32), "count": count_of(0)}
    before = kernels.counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.probe_ranks_kernel(cfg, eng.tables[0], kt, mins, active, count_of(3), "stream",
                                   sh, sentinel("stream", P_RANKS, False), lists=lists)
    assert kernels.counts() == before
    with pytest.raises(ValueError, match="full fields"):
        probe_ranks(cfg, eng.tables[0], kt, mins, active, count_of(3), "stream", sh,
                    sentinel("full", P_RANKS, False, packed=True), lists=lists)
    with pytest.raises(ValueError, match="fields"):
        probe_ranks(cfg, eng.tables[0], kt, mins, active, count_of(3), "ids", sh,
                    sentinel("ids", P_RANKS, False), lists=lists)
    with pytest.raises(ValueError, match="shard form"):
        probe_ranks(cfg, eng.tables[0], kt, mins, active, count_of(3), "stream", None,
                    sentinel("stream", P_RANKS, False), lists=lists)
    ceng = ShardedEngine(index("m13_canonical"), LocalMesh((1, 2), "cpu"))
    with pytest.raises(ValueError, match="RC round"):
        probe_ranks(ceng.cfg, ceng.tables[0], kt, mins, active, count_of(3), "stream",
                    ceng.probe_shards[0], sentinel("stream", P_RANKS, False), lists=lists,
                    rc_round=True)
    v2 = ShardedEngine(idx, LocalMesh((1, 2), "cpu"), row_format="v2")
    with pytest.raises(ValueError, match="v1 rows"):
        probe_ranks(v2.cfg, v2.tables[0], kt, mins, active, count_of(3), "stream",
                    v2.probe_shards[0], sentinel("stream", P_RANKS, False), lists=lists)


@functools.lru_cache(maxsize=None)
def jax_engine(name):
    """The JAX package's engine of the small index `name` (its arrays and
    StaticCfg)."""
    import sshash_tpu
    from test_torch_host import jax_index

    return sshash_tpu.Dictionary(jax_index(index(name))).to_device()


def jax_slots(name, minval):
    """The JAX package's MPHF slot (sshash_tpu/engine.py
    mphf_eval_minimizer) of each minimizer value (int64 numpy)."""
    import jax.numpy as jnp
    from sshash_tpu.engine import mphf_eval_minimizer
    from sshash_tpu.ops import u64 as ju

    jeng = jax_engine(name)
    mv = np.asarray(minval, dtype=np.int64).astype(np.uint64)
    pair = ju.u64(jnp.asarray((mv >> np.uint64(32)).astype(np.uint32)),
                  jnp.asarray((mv & np.uint64(M32)).astype(np.uint32)))
    return np.asarray(mphf_eval_minimizer(jeng.cfg, jeng.arrs, pair)).astype(np.int64)


def round_minval(cfg, mins, rc_round):
    """The minimizer value each rank probes (numpy int64): the canonical
    fold's, or the round's strand."""
    mv_f, mv_r = mins[0].numpy(), mins[2].numpy()
    return np.minimum(mv_f, mv_r) if cfg.canonical else mv_r if rc_round else mv_f


def lists_of(lists):
    """A list pass's list as numpy (rank, key as u32) rows, by rank."""
    n = int(lists["count"][0])
    e = lists["entries"][:n].cpu().numpy().astype(np.int64)
    e[:, 1] &= M32
    return e[np.argsort(e[:, 0], kind="stable")]


@pytest.mark.parametrize("count", LIST_COUNTS)
@pytest.mark.parametrize("name", ["m13_regular", "m13_canonical", "m3_skew", "partitioned"])
def test_rank_lists_plain_deals_active_ranks_to_their_owners(name, count):
    """The list pass's plain version on a (1, 4) row: over the row's keys
    every active rank below the count (some, all, none) is in the list with
    the JAX package's MPHF slot, in rank order, and over each shard's keys
    exactly its owner's ranks are, so that every active rank is in exactly
    one shard's list; with fill the inactive ranks below the count read not
    found and the active ones and those past it keep the sentinel, and
    without it nothing is stored; in the RC round (regular) the forward
    round's found ranks go to no list; the packed form's list leaves the
    combine's identity on every other rank; a range past the table lists
    nothing and one over all of it every active rank."""
    eng = ShardedEngine(index(name), LocalMesh((1, 4), "cpu"))
    cfg, per, shards = eng.cfg, eng.geometry["per_shard"], eng.probe_shards
    whole = ProbeShard(shards[0].slot_lo, shards[-1].slot_hi, shards[0].hrow_lo,
                       shards[-1].hrow_hi)
    kt, active, mins = rank_batch(eng, 9)
    cnt = count_of(count)
    masks = {"some": active, "all": None, "none": torch.zeros(P_RANKS, dtype=torch.bool)}
    for rc_round in (False,) if cfg.canonical else (False, True):
        slots = jax_slots(name, round_minval(cfg, mins, rc_round))
        for what, act in masks.items():
            out = sentinel("stream", P_RANKS, eng.handoff)
            out.pop("slot")
            found = np.zeros(P_RANKS, dtype=bool)
            if rc_round:  # the forward round found every third rank
                found[::3] = True
                out["found"][:] = torch.from_numpy(found)
            kept = {key: v.clone() for key, v in out.items()}
            on = np.ones(P_RANKS, bool) if act is None else act.numpy().copy()
            on[count:] = False
            on &= ~found
            owner, seen = slots // per, np.zeros(P_RANKS, dtype=int)
            for j, sh in enumerate(shards):
                got = lists_of(rank_lists_plain(cfg, eng.tables[0], kt, mins, act, cnt,
                                                "stream", sh, out, rc_round=rc_round))
                want = np.nonzero(on & (owner == j))[0]
                assert np.array_equal(got[:, 0], want), (what, rc_round, j)
                assert np.array_equal(got[:, 1], slots[want]), (what, rc_round, j)
                seen[got[:, 0]] += 1
            assert np.array_equal(seen, on.astype(int)), (what, rc_round)
            for key, v in out.items():
                assert torch.equal(v, kept[key]), (what, rc_round, key)
            got = lists_of(rank_lists_plain(cfg, eng.tables[0], kt, mins, act, cnt, "stream",
                                            whole, out, fill=not rc_round, rc_round=rc_round))
            assert np.array_equal(got[:, 0], np.nonzero(on)[0]), (what, rc_round)
            assert np.array_equal(got[:, 1], slots[on]), (what, rc_round)
            orient = out["kmer_orientation"].numpy()
            below = np.arange(P_RANKS) < count
            idle = below & ~on & ~found if not rc_round else np.zeros(P_RANKS, bool)
            assert (orient[idle] == 1).all() and (out["kmer_id"].numpy()[idle] == -1).all()
            assert (orient[~idle] == 7).all() and (out["kmer_id"].numpy()[~idle] == MARK).all()
    # the packed form: shard 1's list, the identity on every rank it does not take
    pk = sentinel("full", P_RANKS, eng.handoff, packed=True)
    lists = rank_lists_plain(cfg, eng.tables[1], kt, mins, active, cnt, "full", shards[1], pk)
    slots = jax_slots(name, round_minval(cfg, mins, False))
    mine = active.numpy() & (np.arange(P_RANKS) < count) & (slots // per == 1)
    assert np.array_equal(lists_of(lists)[:, 0], np.nonzero(mine)[0])
    ident = (np.arange(P_RANKS) < count) & ~mine
    assert (pk["packed"][:, mine | (np.arange(P_RANKS) >= count)] == MARK).all()
    assert torch.equal(pk["packed"][:-3, ident], torch.full_like(pk["packed"][:-3, ident],
                                                                  0x7FFFFFFF))
    assert (pk["packed"][-3:, ident] == torch.tensor([[1], [1], [0]])).all()
    # one range over the whole table, one past it
    for sh, want in ((ProbeShard(0, 1 << 32), active.numpy() & (np.arange(P_RANKS) < count)),
                     (ProbeShard(1 << 32, 1 << 33), np.zeros(P_RANKS, dtype=bool))):
        out = sentinel("stream", P_RANKS, eng.handoff)
        lists = rank_lists_plain(cfg, eng.tables[0], kt, mins, active, cnt, "stream", sh, out)
        assert np.array_equal(lists_of(lists)[:, 0], np.nonzero(want)[0])


def test_rank_lists_raise_on_what_they_do_not_take():
    """The list probe takes a row of consecutive shard ranges of one width,
    one shard in the packed form, and the list pass's list; the list
    pass's kernel CUDA tensors only."""
    eng = ShardedEngine(index("m13_regular"), LocalMesh((1, 4), "cpu"))
    cfg, sh = eng.cfg, eng.probe_shards
    kt, active, mins = rank_batch(eng, 3)
    out = sentinel("stream", P_RANKS, False)
    args = (cfg, eng.tables[0], kt, mins, active, count_of(3), "stream")
    lists = rank_lists(*args, sh[0], out)
    rows = (cfg, [eng.tables[0]] * 2, *args[2:])
    with pytest.raises(ValueError, match="consecutive"):
        probe_ranks(*rows, [sh[0], sh[2]], out, lists=lists)
    with pytest.raises(ValueError, match="packed form's list probe"):
        probe_ranks(*rows[:6], "full", sh[:2], sentinel("full", P_RANKS, False, packed=True),
                    lists=lists)
    with pytest.raises(ValueError, match="a table dict each"):
        probe_ranks(*args, sh[:2], out, lists=lists)
    with pytest.raises(TypeError, match="lists"):
        probe_ranks(*args, sh[0], out)
    before = kernels.counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.rank_lists_kernel(*args, sh[0], out)
    assert kernels.counts() == before


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
    the plain version of) kernel 2's rank form's list pass and its list
    probe once a round (and hand-off pass) for the data row's shards, the
    list probe over all of them, the anchors' lookup likewise."""
    for name, shape in (("m13_regular", (1, 2)), ("m13_canonical", (1, 4))):
        idx = index(name)
        eng = ShardedEngine(idx, LocalMesh(shape, "cpu"))
        path = stream_reads(idx, np.random.default_rng(12), str(tmp_path / f"{name}.fq"),
                            n_index=40, n_random=20)
        calls, lists = [], []
        plain, lists_plain = E.probe_ranks.plain, E.rank_lists.plain
        with monkeypatch.context() as m:
            lane_forms_refused(m)
            m.setattr(E.probe_ranks, "plain",
                      lambda *a, **kw: calls.append((a[6], len(a[7]))) or plain(*a, **kw))
            m.setattr(E.rank_lists, "plain",
                      lambda *a, **kw: lists.append(a[6]) or lists_plain(*a, **kw))
            rep, st = run_stream(eng, path)
        assert rep == ST.host_report(idx, path)
        rounds = 1 if eng.cfg.canonical else 2
        per_chunk = 3 * rounds  # the anchors and the two lookups over the misses
        assert len(calls) == len(lists) == st.chunks * per_chunk
        assert {n for _, n in calls} == {shape[1]}  # every shard of the row in one call
        assert [f for f, _ in calls].count("full") == lists.count("full") == st.chunks * rounds


@pytest.mark.parametrize("name", ["m13_regular", "m3_skew"])
def test_sharded_stream_on_a_row_past_a_launch_of_shards(name, tmp_path, monkeypatch):
    """ShardedStream on a (1, 16) mesh, a row of twice the shards one list
    probe launch serves (layout.MAX_ROW_SHARDS), runs no lane form, gives
    the list probe the row's 16 shards in each call and equals the host
    _Batcher."""
    assert 16 == 2 * MAX_ROW_SHARDS
    idx = index(name)
    eng = ShardedEngine(idx, LocalMesh((1, 16), "cpu"))
    n = 20 if name == "m3_skew" else 60
    path = stream_reads(idx, np.random.default_rng(14), str(tmp_path / "reads.fq"), n, n)
    calls, plain = [], E.probe_ranks.plain
    with monkeypatch.context() as m:
        lane_forms_refused(m)
        m.setattr(E.probe_ranks, "plain",
                  lambda *a, **kw: calls.append(len(a[7])) or plain(*a, **kw))
        rep, _ = run_stream(eng, path)
    assert rep == ST.host_report(idx, path)
    assert calls and set(calls) == {16}


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
    """Kernel 2's rank form on every shard of a (1, 3) mesh, a list pass
    over the shard's keys and the list probe of its list, against its plain
    version: the owned stores (stream and full fields) after every pass
    over a sentinel, through both rounds and the hand-off's passes, and the
    packed buffers, at every count, nothing written at or past the count;
    then ShardedStream on the card launches kernel 1's and kernel 2's rank
    forms and neither lane form, equals the host _Batcher, and its step
    captured in a CUDA graph replays to the same counters."""
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
                    for kernel, out in zip((True, False), outs):
                        list_and_probe(kernel, cfg, eng.tables[j], kt, mins, act, cnt, fields, sh,
                                       out, fill=j == 0 and not rc, rc_round=rc)
                    _equal(outs, (name, count, fields, rc, j))
                if eng.handoff:
                    for j, sh in enumerate(eng.probe_shards):
                        for kernel, out in zip((True, False), outs):
                            list_and_probe(kernel, cfg, eng.tables[j], kt, mins, act, cnt, fields,
                                           sh, out, rc_round=rc, hrows=out["hrow"])
                        _equal(outs, (name, count, fields, rc, j, "second pass"))
            assert (outs[0]["kmer_id"][count:] == MARK).all()
        for rc in (False,) if cfg.canonical else (False, True):
            for j, sh in enumerate(eng.probe_shards):
                pair = [list_and_probe(kernel, cfg, eng.tables[j], kt, mins, active, cnt, "full",
                                       sh, sentinel("full", P_RANKS, eng.handoff, card,
                                                    packed=True), rc_round=rc)
                        for kernel in (True, False)]
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


CARD_P = 4099  # the list pass's tiles are 1,024 ranks: four and a few ranks
CARD_COUNTS = (0, 1, 31, 32, 33, 45, CARD_P)


def row_rounds(eng, shards, tables, kt, mins, act, cnt, fields, outs, what):
    """Every round (and hand-off pass) of the rank form on a LocalMesh row
    of `shards` (tables[n]: shard n's), the kernels into outs[0] and their
    plain versions into outs[1], in two forms by turns: the row's (one
    list pass over the row's keys, one list probe over every shard, a
    launch for each MAX_ROW_SHARDS of them) and a list a shard's (a list
    pass over each shard's keys, then that shard's list probe). Each list
    pass equal in its stores and its list (compared by rank), each list
    probe in its stores."""
    cfg = eng.cfg
    whole = ProbeShard(shards[0].slot_lo, shards[-1].slot_hi, shards[0].hrow_lo,
                       shards[-1].hrow_hi)
    n_pass = 0
    for rc in (False,) if cfg.canonical else (False, True):
        for hand in (False, True) if eng.handoff else (False,):
            row_form = n_pass % 2 == 0
            n_pass += 1
            calls = [(tables, shards, whole)] if row_form else [
                (tables[j], sh, sh) for j, sh in enumerate(shards)]
            for n, (tab, sh, keys) in enumerate(calls):
                before = kernels.counts()
                lists = [fn(cfg, tables[0], kt, mins, act, cnt, fields, keys, out,
                            fill=not (rc or hand or n), rc_round=rc,
                            hrows=out["hrow"] if hand else None)
                         for fn, out in zip((rank_lists, rank_lists_plain), outs)]
                assert kernels.counts()["rank_lists_kernel"] == before["rank_lists_kernel"] + 1
                _equal(outs, (what, rc, hand, "list pass", row_form, n))
                assert np.array_equal(lists_of(lists[0]), lists_of(lists[1])), \
                    (what, rc, hand, row_form, n)
                for fn, out, lst in zip((probe_ranks, probe_ranks_plain), outs, lists):
                    fn(cfg, tab, kt, mins, act, cnt, fields, sh, out, lists=lst, rc_round=rc,
                       hrows=out["hrow"] if hand else None)
                _equal(outs, (what, rc, hand, "list probe", row_form, n))
                launches = -(-len(shards) // MAX_ROW_SHARDS) if row_form else 1
                assert kernels.counts()["probe_ranks_kernel"] == \
                    before["probe_ranks_kernel"] + launches


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["m13_regular", "m13_canonical", "m3_skew", "m3_skew_canonical",
                                  "k65", "k65_canonical", "k129_canonical"])
def test_list_pass_and_list_probe_equal_plain_on_card(card, name):
    """The list pass and the list probe on a (1, 4) row against their
    plain versions at counts 0, 1, 31, 32, 33, 45 and P, with some, all
    and no ranks active (the stream's fields; the anchors' full fields with
    all), through both rounds, the RC round's merge in place and the
    hand-off's two passes, in the row's form (one list, one probe launch
    for every shard) and a list a shard's (a list pass and a probe launch
    a shard); nothing at or past the count written. Then a row of two
    ranges, one over the whole table (it owns every rank) and one past it
    (it owns none); the packed form on each shard; and the row's
    rank-space lookup captured in a CUDA graph, replayed at other counts
    written into its count tensor in place."""
    idx = index(name)
    eng = ShardedEngine(idx, LocalMesh((1, 4), card))
    cfg = eng.cfg
    kt, active, mins = rank_batch(eng, 21, card, CARD_P)
    masks = {"some": active, "all": None,
             "none": torch.zeros(CARD_P, dtype=torch.bool, device=card)}
    tables = [eng.tables[j] for j in range(4)]
    one = ShardedEngine(idx, LocalMesh((1, 1), card))
    sh = one.probe_shards[0]
    w, hw = sh.slot_hi - sh.slot_lo, sh.hrow_hi - sh.hrow_lo
    past = ProbeShard(sh.slot_hi, sh.slot_hi + w, sh.hrow_hi, sh.hrow_hi + hw)
    for count in CARD_COUNTS:
        cnt = count_of(count, card)
        for fields, what in (("stream", "some"), ("stream", "all"), ("stream", "none"),
                             ("full", "all")):
            outs = [sentinel(fields, CARD_P, eng.handoff, card) for _ in range(2)]
            for out in outs:
                out.pop("slot")
            row_rounds(eng, eng.probe_shards, tables, kt, mins, masks[what], cnt, fields, outs,
                       (name, count, what, fields))
            assert (outs[0]["kmer_id"][count:] == MARK).all()
            assert (outs[0]["kmer_orientation"][count:] == 7).all()
            if count:
                assert not (outs[0]["kmer_orientation"][:count] == 7).any()
        outs = [sentinel("stream", CARD_P, eng.handoff, card) for _ in range(2)]
        for out in outs:
            out.pop("slot")
        row_rounds(one, [sh, past], [one.tables[0]] * 2, kt, mins, active, cnt, "stream", outs,
                   (name, count, "whole and past"))
        for rc in (False,) if cfg.canonical else (False, True):
            for j, shard in enumerate(eng.probe_shards):
                pair = [list_and_probe(kernel, cfg, eng.tables[j], kt, mins, active, cnt, "full",
                                       shard, sentinel("full", CARD_P, eng.handoff, card,
                                                       packed=True), rc_round=rc)
                        for kernel in (True, False)]
                _equal(pair, (name, count, "packed", rc, j))
                assert (pair[0]["packed"][:, count:] == MARK).all()
    fn = eng._ranks_fn(0, "stream")
    cnt = count_of(CARD_P, card)
    want = fn(cfg, None, kt, mins, active, cnt)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fn(cfg, None, kt, mins, active, cnt)
    for count in (CARD_P, 45, 0, 1025):
        cnt.fill_(count)
        graph.replay()
        plain = eng._ranks_fn(0, "stream")
        with pytest.MonkeyPatch.context() as m:
            for entry in (rank_lists, probe_ranks):
                m.setattr(entry, "kernel", entry.plain)
            want = plain(cfg, None, kt, mins, active, cnt)
        torch.cuda.synchronize()
        for key in want:
            assert torch.equal(got[key][:count], want[key][:count]), (count, key)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["m13_regular", "m3_skew"])
def test_rank_form_past_a_launch_of_shards_on_card(card, name, tmp_path):
    """A (1, 16) row, twice the shards one list probe launch serves: the
    list pass and the list probe (two launches a call) against their plain
    versions at counts 45 and P, some ranks active, through both rounds
    and the hand-off's passes; then ShardedStream on the row equals the
    host _Batcher, with two list probe launches for each list pass."""
    idx = index(name)
    eng = ShardedEngine(idx, LocalMesh((1, 16), card))
    assert len(eng.probe_shards) == 2 * MAX_ROW_SHARDS
    kt, active, mins = rank_batch(eng, 23, card, CARD_P)
    tables = [eng.tables[j] for j in range(16)]
    for count in (45, CARD_P):
        outs = [sentinel("stream", CARD_P, eng.handoff, card) for _ in range(2)]
        for out in outs:
            out.pop("slot")
        row_rounds(eng, eng.probe_shards, tables, kt, mins, active, count_of(count, card),
                   "stream", outs, (name, count))
        assert (outs[0]["kmer_id"][count:] == MARK).all()
    path = stream_reads(idx, np.random.default_rng(14), str(tmp_path / "reads.fq"))
    kernels.reset_counts()
    rep, _ = run_stream(eng, path)
    c = kernels.counts()
    assert rep == ST.host_report(idx, path)
    assert c["rank_lists_kernel"] > 0 and c["probe_ranks_kernel"] == 2 * c["rank_lists_kernel"]


def _equal(pair, what):
    a, b = pair
    assert a.keys() == b.keys(), what
    for key in a:
        assert torch.equal(a[key], b[key]), (what, key)
