"""The bucket-sharded lookup's owner-written form (kernel 2's shard form
storing each lane once, from the shard that owns it, into the mesh row's
result tensors) against the stacked combine it replaces (each shard's
packed buffer, a stack and a signed min), the unsharded engine, the JAX
package's ShardedEngine on the virtual CPU mesh and the oracle; the owner
contract itself (one owner a lane and a pass, no lane left unwritten); and
the mesh's combine (csrc/combine.cu's plain version) in u32 order. On the
CPU every kernel call takes its plain version; the card tests hold the
kernels to them. Outputs are integers: tolerance 0."""

import numpy as np
import pytest
import torch
from sshash_tpu.parallel import ShardedEngine as JaxShardedEngine

from sshash_tpu_torch import TorchEngine, kernels, oracle, synthetic
from sshash_tpu_torch import engine as E
from sshash_tpu_torch import kmer as K
from sshash_tpu_torch import streaming as ST
from sshash_tpu_torch.engine import canonical_fold, probe_plain, unpack_result
from sshash_tpu_torch.layout import packed_rows
from sshash_tpu_torch.ops import packed as P
from sshash_tpu_torch.parallel import LocalMesh, ShardedEngine, ShardedStream
from sshash_tpu_torch.parallel.mesh import combine, combine_plain
from test_torch_host import jax_index
from test_torch_kernels import MARK, sentinel_result, shard_rounds
from test_torch_sharded import jax_mesh, straddling_reads
from one_thread import one_torch_thread  # noqa: F401

INVALID = np.uint64(2 ** 64 - 1)
M32 = 0xFFFFFFFF
SHAPES = [(1, 2), (1, 4), (2, 2)]
# an index with skew classes hands heavy lanes between shards (m3_skew*),
# in the legacy forms too (their hindex derived by layout.class_hindex)
FORMS = {"m13_regular": None, "m13_canonical": None, "m3_skew": None,
         "m3_skew_canonical": None, "partitioned": None, "k63": None,
         "legacy_m3_skew": "no hindex", "legacy_plain_m3_skew_canonical": "plain class MPHFs",
         "v2_m3_skew": "v2", "k65_canonical": None, "k129_canonical": None}


def index_of(name):
    if name.startswith("legacy_plain_"):
        return synthetic.legacy_skew(synthetic.small_index(name[13:]), plain_mphf=True)
    if name.startswith("legacy_"):
        return synthetic.legacy_skew(synthetic.small_index(name[7:]))
    return synthetic.small_index(name[3:] if name.startswith("v2_") else name)


def batch(idx, seed, n=301):
    """n positives (the first half reverse-complemented) then n/4 + 3
    random kmers: an odd length, no multiple of 16."""
    rng = np.random.default_rng(seed)
    km = oracle.access(idx, rng.integers(0, idx.num_kmers, n))
    km[: n // 2] = K.revcomp_kmers(km[: n // 2], idx.k)
    return np.concatenate([km, synthetic.random_kmers(idx.k, rng, n // 4 + 3)])


def stacked_lookup(eng, kt, fields):
    """The stacked combine the owner-written form replaces, through the
    plain versions: per shard every lane into its own packed buffer, the
    hand-off's rows by unsigned min, the buffers by a stack and a signed
    min, the regular mode's two rounds merged by engine._merge."""
    cfg = eng.cfg

    def probe_stacked(cfg_, _tables, km, kr, mv, mp, mp2, active, fields_):
        outs = []
        for j, sh in enumerate(eng.probe_shards):
            out = {"packed": torch.full((packed_rows(fields_), km.shape[0]), MARK,
                                        dtype=torch.int32)}
            if eng.handoff:
                out["hrow"] = torch.full((km.shape[0],), MARK, dtype=torch.int32)
            outs.append(probe_plain(cfg, eng.tables[j], km, kr, mv, mp, mp2, active, fields_,
                                    sh, out=out))
        if eng.handoff:
            hrow = combine_plain("min", True, *(o.pop("hrow") for o in outs))
            for j, (sh, o) in enumerate(zip(eng.probe_shards, outs)):
                probe_plain(cfg, eng.tables[j], km, kr, mv, mp, mp2, None, fields_, sh,
                            hrows=hrow, out=o)
        return unpack_result(torch.stack([o["packed"] for o in outs]).amin(0), fields_)

    return E._lookup_two_kernels(cfg, None, kt, None, None, fields, P.minimizer_plain,
                                 probe_stacked)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(FORMS))
def test_owner_written_lookup_equals_stacked_combine_and_oracle(name, shape):
    """Every field of the owner-written lookup equals the stacked combine's,
    the unsharded engine's and the oracle's, on positives and misses, in
    both modes, hindex hand-off and legacy skew forms, v1 and v2 rows, k up
    to 129."""
    idx = index_of(name)
    fmt = "v2" if FORMS[name] == "v2" else None
    eng = ShardedEngine(idx, LocalMesh(shape, "cpu"), row_format=fmt)
    q = batch(idx, 7)
    got, rep = eng.lookup(q)
    fields = eng.fields
    teng = TorchEngine(idx, "cpu", row_format=fmt)
    ref = E._to_host_result(E.lookup(teng.cfg, teng.tables, eng.kmers32(q), None, fields))
    want = oracle.lookup(idx, q)
    for key in got:
        assert np.array_equal(got[key], ref[key]), key
        assert np.array_equal(got[key], want[key]), key
    assert rep == {"num_kmers": len(q), "num_positive": int((want["kmer_id"] != INVALID).sum())}
    if shape[0] == 1:  # one data row: the stacked combine on the same lanes
        kt = eng.kmers32(q)
        stacked = stacked_lookup(eng, kt, fields)
        owned = eng.lookup_device(kt, fields)[0]
        assert stacked.keys() == owned.keys()
        for key in owned:
            assert torch.equal(owned[key], stacked[key]), key


@pytest.mark.parametrize("name,shape", [("m3_skew", (1, 4)), ("legacy_m3_skew", (2, 2)),
                                        ("m13_regular", (1, 2))])
def test_owner_written_lookup_equals_jax(name, shape):
    """The regular mode's RC round merged in place, with the hand-off and
    without, against the JAX ShardedEngine in every field and the
    report."""
    idx = index_of(name)
    q = batch(idx, 11, n=255)
    want, want_rep = JaxShardedEngine(jax_index(idx), jax_mesh(shape)).lookup(q)
    got, rep = ShardedEngine(idx, LocalMesh(shape, "cpu")).lookup(q)
    assert set(got) == set(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    assert rep == want_rep


def _copy(out):
    return {key: v.clone() for key, v in out.items()}


@pytest.mark.parametrize("name", ["m3_skew", "m3_skew_canonical", "legacy_m3_skew", "k63",
                                  "k129_canonical"])
@pytest.mark.parametrize("nb", [2, 4])
def test_every_lane_has_one_owner_in_each_pass(name, nb):
    """Each shard's stores, run alone over a sentinel: in every first pass
    the active lanes' owners' masks sum to 1 (the inactive lanes' to 0,
    stored by the fill launch alone); the RC round's to 1 over the lanes
    the forward round left unfound; a hand-off pass's to at most 1, on the
    lanes whose handed row the storing shard holds, covering every hit."""
    idx = index_of(name)
    eng = ShardedEngine(idx, LocalMesh((1, nb), "cpu"))
    cfg = eng.cfg
    kt = eng.kmers32(batch(idx, 3))
    B = kt.shape[0]
    active = torch.from_numpy(np.random.default_rng(5).random(B) < 0.85)
    out = sentinel_result(eng.fields, B, eng.handoff, "cpu")
    per_hr = eng.geometry["per_shard_hrows"]
    assert eng.handoff == (name in ("m3_skew", "m3_skew_canonical", "legacy_m3_skew",
                                    "k129_canonical"))
    for args, rc in shard_rounds(cfg, kt):
        todo = active & ~out["found"] if rc else active
        before = _copy(out)
        before["kmer_orientation"].fill_(7)
        owners = torch.zeros(B, dtype=torch.int64)
        for j, sh in enumerate(eng.probe_shards):
            alone = _copy(before)
            probe_plain(cfg, eng.tables[j], *args, active, eng.fields, sh, out=alone,
                        rc_round=rc)
            owners += (alone["kmer_orientation"] != 7).to(torch.int64)
        assert torch.equal(owners, todo.to(torch.int64))
        for n, (j, sh) in enumerate(zip(eng.tables, eng.probe_shards)):
            probe_plain(cfg, eng.tables[j], *args, active, eng.fields, sh, out=out,
                        fill=n == 0 and not rc, rc_round=rc, slots="read" if n else "store")
        assert not (out["kmer_orientation"] == 7).any()
        if not eng.handoff:
            continue
        # the hand-off's second pass over the first pass's rows, shard by
        # shard alone, then all of them
        first = _copy(out)
        h = first["hrow"].to(torch.int64) & M32
        assert rc or bool((h[todo] != M32).any())
        hits = torch.zeros(B, dtype=torch.int64)
        for j, sh in enumerate(eng.probe_shards):
            alone = _copy(first)
            alone["kmer_orientation"].fill_(7)
            probe_plain(cfg, eng.tables[j], *args, active, eng.fields, sh, hrows=first["hrow"],
                        out=alone, rc_round=rc)
            wrote = alone["kmer_orientation"] != 7
            assert bool(((h[wrote] // per_hr) == j).all())
            assert bool(alone["found"][wrote].all())
            hits += wrote.to(torch.int64)
        for j, sh in enumerate(eng.probe_shards):
            probe_plain(cfg, eng.tables[j], *args, active, eng.fields, sh, hrows=out["hrow"],
                        out=out, rc_round=rc)
        assert int(hits.max()) <= 1
        assert torch.equal(hits > 0, out["found"] & ~first["found"])
    want = E.lookup(cfg, TorchEngine(idx, "cpu").tables, kt, active, eng.fields)
    for key in want:
        assert torch.equal(out[key], want[key]), key


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["m13_regular", "m3_skew", "m3_skew_canonical",
                                  "legacy_m3_skew", "v2_m3_skew"])
def test_no_lane_keeps_the_sentinel(name, shape, monkeypatch):
    """The engine's result tensors filled with a sentinel before the lookup:
    after it no lane holds it, in either mode, with a fifth of the lanes
    inactive, and every field equals the unsharded engine's."""
    idx = index_of(name)
    fmt = "v2" if name.startswith("v2_") else None
    eng = ShardedEngine(idx, LocalMesh(shape, "cpu"), row_format=fmt)
    monkeypatch.setattr(eng, "_result_tensors",
                        lambda B, fields: sentinel_result(fields, B, eng.handoff, "cpu"))
    kt = eng.kmers32(batch(idx, 13, n=200))[:252]
    B = kt.shape[0] // shape[0]
    active = torch.from_numpy(np.random.default_rng(2).random(B) < 0.8)
    ref = TorchEngine(idx, "cpu", row_format=fmt)
    for row, part in eng._split(kt).items():
        got = eng._lookup_fn(row, eng.fields)(None, part, active)
        assert not (got["kmer_orientation"] == 7).any()
        assert not (got["kmer_id"] == MARK).any()
        want = E.lookup(ref.cfg, ref.tables, part, active, eng.fields)
        for key in want:
            assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("name", ["m3_skew", "m13_canonical", "k65_canonical"])
def test_navigation_and_stream_report_equal_unsharded(name):
    """Navigation (8 lanes a kmer through one owner-written lookup) equals
    the unsharded engine's; the per-position stream report equals
    derive_report, on (1, 4) and (2, 2)."""
    idx = index_of(name)
    q = batch(idx, 17, n=61)
    ref = TorchEngine(idx, "cpu").kmer_neighbours(q[:64])
    km, valid, first = straddling_reads(idx, np.random.default_rng(3), D=2, per=200)
    res = oracle.lookup(idx, km)
    want = ST.derive_report(res["kmer_id"] != INVALID, res["string_id"], res["kmer_id"],
                            res["kmer_orientation"], valid, first)
    for shape in ((1, 4), (2, 2)):
        eng = ShardedEngine(idx, LocalMesh(shape, "cpu"))
        got = eng.kmer_neighbours(q[:64])
        for key in ref:
            assert np.array_equal(got[key], ref[key]), key
        assert eng.stream_report(km, valid, first) == want


@pytest.mark.parametrize("name", ["m3_skew", "m13_canonical"])
def test_sharded_stream_equals_batcher(name, tmp_path):
    """ShardedStream's misses go through the owner-written lookup with an
    active mask (the run-skip heads, then round 2): reads with RC,
    substitutions and Ns report as the host _Batcher does, on (1, 4) and
    (2, 2)."""
    idx = index_of(name)
    rng = np.random.default_rng(8)
    strings = synthetic.index_strings(idx)
    fq = str(tmp_path / "reads.fq")
    reads = synthetic.cut_reads(strings, 150, 80, rng, rc=0.5, subst=0.02)
    synthetic.write_reads(fq, synthetic.with_n(reads + synthetic.random_reads(150, 70, rng),
                                               0.05, rng))
    want = ST.host_report(idx, fq)
    for shape in ((1, 4), (2, 2)):
        s = ShardedStream(ShardedEngine(idx, LocalMesh(shape, "cpu")), pmax=1 << 11)
        for seq in ST.parse_reads(fq):
            s.add_read(seq)
        assert s.finalize() == want


U32S = np.array([0, 1, 5, 0x7FFFFFFF, 1 << 31, 0x80000001, 0xFFFFFFFE, 0xFFFFFFFF],
                dtype=np.uint32)


@pytest.mark.parametrize("nb", [1, 2, 4, 9])
def test_combine_plain_orders_ids_above_2_31_as_u32(nb):
    """The combine's plain version against numpy's u32 reduction: ids at and
    above 2^31 (0xFFFFFFFF the largest), signed order without unsigned,
    int32 sums wrapping, int64 sums exact; LocalMesh's combines on the CPU
    take it (a group of one is its own combine)."""
    rng = np.random.default_rng(nb)
    vals = rng.choice(U32S, size=(nb, 37))
    ts = [torch.from_numpy(v.view(np.int32).copy()) for v in vals]
    u = lambda t: t.numpy().view(np.uint32)  # noqa: E731
    assert np.array_equal(u(combine_plain("min", True, *ts)), vals.min(0))
    assert np.array_equal(u(combine_plain("max", True, *ts)), vals.max(0))
    assert np.array_equal(combine_plain("min", False, *ts).numpy(),
                          vals.view(np.int32).min(0))
    assert np.array_equal(u(combine_plain("sum", False, *ts)),
                          vals.astype(np.uint64).sum(0).astype(np.uint32))
    big = [t.to(torch.int64) << 20 for t in ts]
    assert torch.equal(combine_plain("sum", False, *big), torch.stack(big).sum(0))
    assert combine_plain("sum", False, *ts).dtype == torch.int32
    mesh = LocalMesh((1, nb), "cpu")
    values = {(0, j): t for j, t in enumerate(ts)}
    for op, want in (("pmin", vals.min(0)), ("pmax", vals.max(0))):
        for t in getattr(mesh, op)(values, "bucket", unsigned=True).values():
            assert np.array_equal(u(t), want)
    before = kernels.counts()
    assert torch.equal(combine("max", True, *ts), combine_plain("max", True, *ts))
    assert kernels.counts() == before


def test_shard_form_checks_its_call():
    """A shard's probe stores into out; the packed buffer takes neither fill
    nor the RC round; the RC round is the regular mode's; the hand-off's
    first pass needs out['hrow']; the unsharded form takes none of it."""
    idx = synthetic.small_index("m3_skew")
    eng = ShardedEngine(idx, LocalMesh((1, 2), "cpu"))
    cfg, sh = eng.cfg, eng.probe_shards[0]
    kt = eng.kmers32(batch(idx, 1, n=20))
    (args, _), _ = shard_rounds(cfg, kt)
    t = eng.tables[0]
    with pytest.raises(ValueError, match="stores into out"):
        probe_plain(cfg, t, *args, None, "full", sh)
    with pytest.raises(ValueError, match="out\\['hrow'\\]"):
        probe_plain(cfg, t, *args, None, "full", sh, out={"found": torch.zeros(25, dtype=bool)})
    packed = {"packed": torch.zeros((9, kt.shape[0]), dtype=torch.int32)}
    with pytest.raises(ValueError, match="fill and rc_round"):
        probe_plain(cfg, t, *args, None, "full", sh, out=packed, fill=True)
    with pytest.raises(ValueError, match="shard form"):
        probe_plain(cfg, t, *args, None, "full",
                    out=sentinel_result("full", kt.shape[0], True, "cpu"))
    ceng = ShardedEngine(synthetic.small_index("m13_canonical"), LocalMesh((1, 2), "cpu"))
    ckt = ceng.kmers32(batch(ceng.index, 1, n=20))
    (cargs, _), = shard_rounds(ceng.cfg, ckt)
    with pytest.raises(ValueError, match="regular mode"):
        probe_plain(ceng.cfg, ceng.tables[0], *cargs, None, "full", ceng.probe_shards[0],
                    out=sentinel_result("full", ckt.shape[0], False, "cpu"), rc_round=True)
