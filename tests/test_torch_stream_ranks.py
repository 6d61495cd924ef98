"""The stream step's missed lanes in rank space: kernel 1's rank form
(ops.packed.minimizer_ranks) and the rank-space lookup
(engine.lookup_ranks), against the JAX package on the CPU (its kernel 1,
its jitted lookup and stream step, its oracle) and against the P-wide
two-kernel form they replace; every entry point running its kernel with
its tensors' card current; and, on a card, each new kernel against its
plain version.

The same seeded numpy inputs go through both sides. Outputs are integers:
the tolerance is 0. JAX and the JAX package are imported inside the CPU
tests' helpers only, so a machine with a card and no JAX runs the card
tests (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_stream_ranks.py
"""

import contextlib
import functools
import os

import numpy as np
import pytest
import torch

# debug and parallel.mesh register their entry points (debug.check,
# mesh.combine) when imported
from sshash_tpu_torch import TorchEngine, debug, kernels, synthetic  # noqa: F401
from sshash_tpu_torch import engine as E
from sshash_tpu_torch import kmer as K
from sshash_tpu_torch import streaming as ST
from sshash_tpu_torch.ops import packed as P
from sshash_tpu_torch.parallel import mesh  # noqa: F401
from one_thread import one_torch_thread  # noqa: F401

INVALID = np.uint64(2 ** 64 - 1)
P_RANKS = 256
COUNTS = (0, 1, 31, 33, P_RANKS - 1, P_RANKS)
# the configurations of the lookup cases: k31, k65 and k129, both modes
LOOKUP_CONFIGS = ("m13_regular", "m13_canonical", "k65", "k65_canonical", "k129_canonical")
LANE_FIELDS = ("found", "string_id", "kmer_id", "kmer_orientation")


def _count(n, dev="cpu"):
    return torch.tensor([n], dtype=torch.int32, device=dev)


def _u32(t):
    return t.cpu().numpy().view(np.uint32).astype(np.uint64)


# ----------------------------------------------------- every entry's card


ENTRIES = {e.kernel.__name__: e for e in kernels.ENTRY_POINTS}


class _Tagged:
    """An argument that carries only a device."""

    def __init__(self, device):
        self.device = device


def test_every_wrapper_has_one_entry_point():
    assert len(ENTRIES) == len(kernels.ENTRY_POINTS)
    assert set(ENTRIES) == {k.__name__ for k in kernels.KERNELS}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entry_runs_its_kernel_on_its_tensors_card(name, monkeypatch):
    """Each entry point calls its CUDA wrapper inside
    torch.cuda.device(the card of its tensor argument), whichever card is
    current, and never its plain version there."""
    entry = ENTRIES[name]
    entered, seen = [], []

    @contextlib.contextmanager
    def device(d):
        entered.append(torch.device(d))
        try:
            yield
        finally:
            entered.pop()

    def kernel(*args, **kw):
        seen.append(list(entered))
        return "launched"

    def plain(*args, **kw):
        raise AssertionError("the plain version ran on a CUDA argument")

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(entry, "kernel", kernel)
    monkeypatch.setattr(entry, "plain", plain)
    for card in (1, 3, 0):
        args = [None] * (entry.arg + 1)
        args[entry.arg] = _Tagged(torch.device("cuda", card))
        assert entry(*args) == "launched"
        assert seen[-1] == [torch.device("cuda", card)]
    assert not entered


def test_rank_wrappers_take_cuda_tensors_only():
    idx = synthetic.small_index("m13_regular")
    eng = TorchEngine(idx, "cpu")
    cfg = eng.cfg
    kt = torch.zeros((64, cfg.W), dtype=torch.int32)
    before = kernels.counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.minimizer_ranks_kernel(kt, _count(3), cfg.k, cfg.m, cfg.magic)
    mins = P.minimizer_ranks_plain(kt, _count(3), cfg.k, cfg.m, cfg.magic)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.lookup_ranks_kernel(cfg, eng.tables, kt, mins, torch.ones(64, dtype=torch.bool),
                                    _count(3))
    with pytest.raises(ValueError, match="active"):
        kernels.lookup_ranks_kernel(cfg, eng.tables, kt, mins, None, _count(3))
    assert kernels.counts() == before
    meta = torch.empty((64, cfg.W), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no minimizer-ranks kernel for device meta"):
        P.minimizer_ranks(meta, _count(3), cfg.k, cfg.m, cfg.magic)
    with pytest.raises(ValueError, match="no lookup-ranks kernel for device meta"):
        E.lookup_ranks(cfg, eng.tables, meta, mins, None, _count(3))


# ------------------------------------------------- kernel 1's rank form


KM = [(31, 13), (65, 21), (129, 31)]


@functools.lru_cache(maxsize=None)
def _kernel1_case(k, m):
    """P_RANKS random kmers, a magic, and JAX's both-strand minimizers of
    every row (mv_f, mp_f, mv_r, mp_r as numpy)."""
    import jax.numpy as jnp
    from sshash_tpu.ops import packed as JP
    from sshash_tpu.ops import u64 as JU

    rng = np.random.default_rng(k)
    k32 = np.ascontiguousarray(K.kmers_to_u32(synthetic.random_kmers(k, rng, P_RANKS), k))
    magic = int(rng.integers(0, 1 << 63))
    jk = jnp.asarray(k32)
    mv_f, mp_f, mv_r, mp_r = JP.compute_minimizer_two_strand(jk, JP.revcomp_kmers(jk, k), k, m,
                                                             JU.const64(magic))

    def u64(pair):
        return (np.asarray(pair.hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
            pair.lo).astype(np.uint64)

    return torch.from_numpy(k32.view(np.int32)), magic, (u64(mv_f), np.asarray(mp_f),
                                                         u64(mv_r), np.asarray(mp_r))


@pytest.mark.parametrize("n", COUNTS)
@pytest.mark.parametrize("k,m", KM)
def test_minimizer_ranks_equal_jax_and_the_lane_form(k, m, n):
    """Below the count, both strands' minimizers equal JAX's
    compute_minimizer_two_strand and today's P-wide kernel 1."""
    kt, magic, want = _kernel1_case(k, m)
    got = P.minimizer_ranks(kt, _count(n), k, m, magic)
    assert all(t.shape == (P_RANKS,) for t in got)
    assert got[0].dtype == got[2].dtype == torch.int64
    assert got[1].dtype == got[3].dtype == torch.int32
    for g, w in zip(got, want):
        assert np.array_equal(g[:n].numpy().astype(w.dtype), w[:n])
    mv_f, mp_f, _, mv_r, mp_r = P.minimizer_plain(kt, k, m, magic, both=True)
    for g, w in zip(got, (mv_f, mp_f, mv_r, mp_r)):
        assert torch.equal(g[:n], w[:n])


# ------------------------------------------------ the rank-space lookup


@functools.lru_cache(maxsize=None)
def _lookup_case(name):
    """An index, its CPU engine, P_RANKS kmers (50%-RC positives and
    random kmers, shuffled) and the JAX package's host-form result on every
    row: its jitted DeviceEngine at k31, its oracle at k65 and k129 (JAX's
    wide lookup compiles for minutes)."""
    import sshash_tpu
    from sshash_tpu import oracle as joracle
    from sshash_tpu.engine import DeviceEngine
    from test_torch_host import jax_index

    idx = synthetic.small_index(name)
    eng = TorchEngine(idx, "cpu")
    rng = np.random.default_rng(len(name))
    q, _ = synthetic.query_batch(idx, seed=len(name))
    q = q[rng.permutation(len(q))[:P_RANKS]]
    jidx = jax_index(idx)
    want = (DeviceEngine(jidx).lookup(q) if idx.k == 31 else joracle.lookup(jidx, q))
    assert isinstance(jidx, sshash_tpu.Index)
    return idx, eng, eng.kmers32(q), want


def _lane_form(eng, kt, active):
    """Today's P-wide two-kernel form (kernel 1 over every row, the fold
    or the RC retry, kernel 2 masked by active), through the plain
    versions."""
    cfg = eng.cfg
    lookup = E.make_lookup(cfg, "full", minimizer=P.minimizer_plain, probe=E.probe_plain)
    return lookup(eng.tables, kt, active)


def _check_ranks(got, lanes, active, n):
    """got (the rank form) equals lanes (the P-wide form) at every rank < n
    in every field the stream reads (minimizer_found at the active ranks,
    where round 2 reads it); inactive ranks report not found with
    minimizer_found 0."""
    assert set(got) == set(kernels.STREAM_FIELDS)
    on = active[:n]
    for f in LANE_FIELDS:
        assert torch.equal(got[f][:n], lanes[f][:n]), f
    assert torch.equal(got["minimizer_found"][:n][on], lanes["minimizer_found"][:n][on])
    off = ~on
    assert not got["found"][:n][off].any() and not got["minimizer_found"][:n][off].any()
    assert (got["kmer_id"][:n][off] == -1).all() and (got["string_id"][:n][off] == -1).all()
    assert (got["kmer_orientation"][:n][off] == 1).all()


@pytest.mark.parametrize("n", COUNTS)
@pytest.mark.parametrize("name", LOOKUP_CONFIGS)
def test_lookup_ranks_equal_jax_and_the_lane_form(name, n):
    """Random active masks: below the count the rank-space lookup equals
    today's P-wide form, and at its active ranks the JAX package's lookup
    in every field it returns there."""
    idx, eng, kt, want = _lookup_case(name)
    cfg = eng.cfg
    active = torch.from_numpy(np.random.default_rng(n).random(P_RANKS) < 0.6)
    mins = P.minimizer_ranks(kt, _count(n), cfg.k, cfg.m, cfg.magic)
    got = E.lookup_ranks(cfg, eng.tables, kt, mins, active, _count(n))
    assert all(t.shape == (P_RANKS,) for t in got.values())
    _check_ranks(got, _lane_form(eng, kt, active), active, n)
    on = active[:n].numpy()
    found = got["found"][:n].numpy()[on]
    assert np.array_equal(found, want["kmer_id"][:n][on] != INVALID)
    for f in ("kmer_id", "string_id"):
        jw = want[f][:n][on]
        assert np.array_equal(_u32(got[f][:n])[on][found], jw[found]), f
        assert (jw[~found] == INVALID).all()
    assert np.array_equal(got["kmer_orientation"][:n].numpy()[on].astype(np.int64),
                          want["kmer_orientation"][:n][on])
    assert np.array_equal(got["minimizer_found"][:n].numpy()[on],
                          want["minimizer_found"][:n][on])
    if n == P_RANKS and on.any():
        assert found.any() and not found.all()


# --------------------------------------- the step's own masks and counts


def _recorded_ops():
    calls = []

    def wrap(name, fn):
        def f(*a, **kw):
            out = fn(*a, **kw)
            calls.append((name, a, out))
            return out
        return f

    ops = ST.KERNEL_OPS._replace(**{n: wrap(n, getattr(ST.KERNEL_OPS, n))
                                    for n in ("minimizer_ranks", "lookup_ranks")})
    return ops, calls


def _stream_reads(idx, rng, tmp):
    """Reads cut from the index (half RC, 1% substitutions), random reads,
    and a run of one repeated kmer, with Ns: every path of the misses."""
    strings = synthetic.index_strings(idx)
    L = min(max(100, idx.k + 37), max(len(s) for s in strings))
    reads = synthetic.cut_reads(strings, 200, L, rng, rc=0.5, subst=0.01)
    reads += synthetic.random_reads(200, max(76, idx.k + 13), rng)
    reads = synthetic.with_n(reads, 0.02, rng) + [b"A" * (3 * idx.k)]
    path = os.path.join(tmp, "reads.fq")
    synthetic.write_reads(path, [reads[i] for i in rng.permutation(len(reads))])
    return path


@pytest.mark.parametrize("runskip", [True, False])
@pytest.mark.parametrize("name", ["m13_regular", "m13_canonical", "k65_canonical",
                                  "k129_canonical"])
def test_step_masks_and_counts_through_the_rank_forms(name, runskip, tmp_path):
    """On every chunk of a stream, each call of the rank forms (kernel 1,
    the heads' round and the round-2 round, at the step's own count and
    masks) equals the P-wide form at every rank below the count, and the
    report equals the host _Batcher."""
    idx = synthetic.small_index(name)
    eng = TorchEngine(idx, "cpu")
    cfg = eng.cfg
    path = _stream_reads(idx, np.random.default_rng(7), str(tmp_path))
    s = ST._DeviceStream(eng, idx.k, pmax=1 << 12, rmax_shift=4, runskip=runskip)
    s.capture = []
    for seq in ST.parse_reads(path):
        s.add_read(seq)
    assert s.finalize() == ST.host_report(idx, path)
    lookup = E.make_lookup(cfg, "full")
    second = 0  # chunks whose round 2 had ranks
    for av, packed in s.capture:
        ops, calls = _recorded_ops()
        ST.make_stream_step(cfg, s.P, s.R, s.CW, lookup, all_valid=av, ops=ops,
                            runskip=runskip)(eng.tables, packed)
        (_, (km, count, *_), mins), *looks = calls
        n = int(count[0])
        mv_f, mp_f, _, mv_r, mp_r = P.minimizer_plain(km, cfg.k, cfg.m, cfg.magic, both=True)
        for g, w in zip(mins, (mv_f, mp_f, mv_r, mp_r)):
            assert torch.equal(g[:n], w[:n])
        assert [c[0] for c in looks] == ["lookup_ranks"] * 2
        for _, (_, _, kmers, given, active, cnt), res in looks:
            assert cnt is count and given is mins and not active[n:].any()
            _check_ranks(res, _lane_form(eng, kmers, active), active, n)
        second += int(looks[1][1][4].any())
    # with the skip off every rank is a head: no round 2
    assert (second > 0) == runskip


@pytest.fixture(scope="module")
def jax_stream(tmp_path_factory):
    """A canonical k31 index, low-hit and mixed reads, and JAX's jitted
    stream step at one chunk shape, compiled once; JAX's report and
    chunks."""
    import jax
    import sshash_tpu
    from sshash_tpu import streaming as JS
    from sshash_tpu.engine import make_lookup as jax_make_lookup
    from test_torch_host import jax_index

    class JaxStream(JS._DeviceStream):
        def _init_host(self, *args):
            super()._init_host(*args)
            self._no_ladder = True
            self._pipe = None
            self._capture = []

    idx = synthetic.small_index("m13_canonical")
    pmax, rshift = 1 << 12, 4
    path = _stream_reads(idx, np.random.default_rng(11), str(tmp_path_factory.mktemp("ranks")))
    jeng = sshash_tpu.Dictionary(jax_index(idx)).to_device()
    R = max(16, pmax >> rshift)
    CW = JS._DeviceStream._cw_words(pmax, R, idx.k)
    full = jax.jit(JS.make_stream_step(jeng.cfg, jax_make_lookup(jeng.cfg), pmax, R,
                                       packed_cw=CW))
    o2 = 2 + R + R // 32 + 1

    def all_valid_as_full(arrs, buf):
        buf = np.asarray(buf)
        vb = np.packbits(np.arange(pmax // 32 * 32 + 32) < int(buf[0]),
                         bitorder="little").view(np.uint32)
        return full(arrs, np.concatenate([buf[:o2], vb, buf[o2:]]))

    jeng._stream_steps = {(pmax, R): full, (pmax, R, "av"): all_valid_as_full}
    js = JaxStream(jeng, idx.k, pmax=pmax, rmax_shift=rshift)
    for seq in JS.parse_reads(path):
        js.add_read(seq)
    return idx, path, js.finalize(), js._capture, jeng, (pmax, rshift, full)


@pytest.mark.parametrize("runskip", [None, True, False])
def test_rank_step_equals_jax_and_host(jax_stream, runskip):
    """With the run-skip at JAX's gate, forced on and forced off, every
    chunk's (3, 4) of the rank-path step equals JAX's jitted step on the
    same buffer, and the report equals JAX's device stream and the host
    _Batcher."""
    idx, path, jrep, chunks, jeng, (pmax, rshift, full) = jax_stream
    eng = TorchEngine(idx, "cpu")
    s = ST._DeviceStream(eng, idx.k, pmax=pmax, rmax_shift=rshift, runskip=runskip)
    assert len(chunks) >= 2
    for fn, jbuf in chunks:
        buf = torch.from_numpy(np.array(jbuf).view(np.int32))
        got = s._steps[fn is not full](eng.tables, buf).numpy().view(np.uint32)
        want = np.asarray(fn(jeng.arrs, jbuf))
        assert np.array_equal(got[0], want[0])
        for i in (1, 2):
            assert got[i, 0] == want[i, 0] and (not want[i, 0] or np.array_equal(got[i], want[i]))
    for seq in ST.parse_reads(path):
        s.add_read(seq)
    rep = s.finalize()
    assert rep == {key: jrep[key] for key in rep} == ST.host_report(idx, path)
    assert rep["num_positive_kmers"] > 0 and rep["num_negative_kmers"] > 0


# ------------------------------------------------------------ on a card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


CARD_P = 4099
CARD_COUNTS = (0, 1, 31, 33, CARD_P - 1, CARD_P)
CARD_KM = [(15, 7), (31, 13), (31, 21), (63, 25), (65, 25), (127, 31), (129, 31), (255, 31)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", CARD_COUNTS)
@pytest.mark.parametrize("k,m", CARD_KM)
def test_minimizer_ranks_kernel_equals_plain_on_card(card, k, m, n):
    rng = np.random.default_rng(k + m)
    k32 = np.ascontiguousarray(K.kmers_to_u32(synthetic.random_kmers(k, rng, CARD_P), k))
    kt = torch.from_numpy(k32.view(np.int32)).to(card)
    magic = int(rng.integers(0, 1 << 63))
    before = kernels.minimizer_ranks_kernel.launches
    got = P.minimizer_ranks(kt, _count(n, card), k, m, magic)
    assert kernels.minimizer_ranks_kernel.launches == before + 1
    want = P.minimizer_ranks_plain(kt, _count(n, card), k, m, magic)
    for g, w in zip(got, want):
        assert torch.equal(g[:n], w[:n])


CARD_CONFIGS = ("m13_regular", "m13_canonical", "m3_skew", "m3_skew_canonical", "m9_c1",
                "partitioned", "k63", "k65", "k65_canonical", "k127_canonical",
                "k129_canonical")


@functools.lru_cache(maxsize=None)
def _card_case(name):
    idx = synthetic.small_index(name)
    eng = TorchEngine(idx, "cuda")
    rng = np.random.default_rng(len(name))
    q, _ = synthetic.query_batch(idx, seed=1)
    q = q[rng.integers(0, len(q), CARD_P)]
    return eng, eng.kmers32(q)


@pytest.mark.cuda
@pytest.mark.parametrize("n", CARD_COUNTS)
@pytest.mark.parametrize("name", CARD_CONFIGS)
def test_lookup_ranks_kernel_equals_plain_on_card(card, name, n):
    eng, kt = _card_case(name)
    cfg = eng.cfg
    active = torch.from_numpy(np.random.default_rng(n).random(CARD_P) < 0.6).to(card)
    mins = P.minimizer_ranks_plain(kt, _count(n, card), cfg.k, cfg.m, cfg.magic)
    before = kernels.lookup_ranks_kernel.launches
    got = E.lookup_ranks(cfg, eng.tables, kt, mins, active, _count(n, card))
    assert kernels.lookup_ranks_kernel.launches == before + 1
    want = E.lookup_ranks_plain(cfg, eng.tables, kt, mins, active, _count(n, card))
    for f in kernels.STREAM_FIELDS:
        assert torch.equal(got[f][:n], want[f][:n]), f


# a warp's 32 ranks and one either side, a count no multiple of 32, a
# block's 1,024 and one either side, and every rank
EDGE_COUNTS = (0, 1, 31, 32, 33, 45, 1023, 1024, 1025, CARD_P)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["m13_regular", "m13_canonical", "m3_skew", "k65",
                                  "k65_canonical", "k129_canonical"])
def test_lookup_ranks_counts_and_masks_equal_plain_on_card(card, name):
    """The rank-space lookup (each warp's active ranks queued in shared
    memory, looked up 32 at a time) against its plain version at counts 0,
    1, 31, 32, 33, 45, a block's edges and P, with some, all, no and a few
    scattered ranks active; then captured in a CUDA graph and replayed at
    other counts written into its count tensor in place."""
    eng, kt = _card_case(name)
    cfg = eng.cfg
    rng = np.random.default_rng(3)
    masks = {"some": rng.random(CARD_P) < 0.25, "all": np.ones(CARD_P, bool),
             "none": np.zeros(CARD_P, bool), "scattered": np.arange(CARD_P) % 997 == 5}
    masks = {key: torch.from_numpy(v).to(card) for key, v in masks.items()}
    mins = P.minimizer_ranks_plain(kt, _count(CARD_P, card), cfg.k, cfg.m, cfg.magic)
    for n in EDGE_COUNTS:
        for what, active in masks.items():
            got = E.lookup_ranks(cfg, eng.tables, kt, mins, active, _count(n, card))
            want = E.lookup_ranks_plain(cfg, eng.tables, kt, mins, active, _count(n, card))
            for f in kernels.STREAM_FIELDS:
                assert torch.equal(got[f][:n], want[f][:n]), (n, what, f)
    cnt = _count(CARD_P, card)
    E.lookup_ranks(cfg, eng.tables, kt, mins, masks["some"], cnt)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = E.lookup_ranks(cfg, eng.tables, kt, mins, masks["some"], cnt)
    for n in (CARD_P, 45, 0, 1025):
        cnt.fill_(n)
        graph.replay()
        want = E.lookup_ranks_plain(cfg, eng.tables, kt, mins, masks["some"], cnt)
        torch.cuda.synchronize()
        for f in kernels.STREAM_FIELDS:
            assert torch.equal(got[f][:n], want[f][:n]), (n, f)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["m13_regular", "m13_canonical", "k65", "k127_canonical",
                                  "k129_canonical"])
def test_stream_misses_go_through_the_rank_kernels_on_card(card, name, tmp_path):
    """The unsharded stream launches kernel 1's rank form and the rank-space
    lookup, and no P-wide kernel 1 or kernel 2; each of their calls equals
    its plain version on the call's own inputs, every chunk's step equals
    the plain step, and the report equals the host _Batcher."""
    idx = synthetic.small_index(name)
    eng = TorchEngine(idx, card)
    path = _stream_reads(idx, np.random.default_rng(5), str(tmp_path))
    s = ST._DeviceStream(eng, idx.k, pmax=1 << 14, rmax_shift=6)
    s.capture = []
    kernels.reset_counts()
    for seq in ST.parse_reads(path):
        s.add_read(seq)
    assert s.finalize() == ST.host_report(idx, path)
    c = kernels.counts()
    assert c["probe_kernel"] == c["minimizer_kernel"] == 0
    assert c["minimizer_ranks_kernel"] == s.chunks and c["lookup_ranks_kernel"] == 2 * s.chunks
    plain_lookup = E.make_lookup(eng.cfg, "full", minimizer=P.minimizer_plain,
                                 probe=E.probe_plain)
    for av, packed in s.capture:
        ops, calls = _recorded_ops()
        got = ST.make_stream_step(eng.cfg, s.P, s.R, s.CW, E.make_lookup(eng.cfg, "full"),
                                  all_valid=av, ops=ops)(eng.tables, packed)
        want = ST.make_stream_step(eng.cfg, s.P, s.R, s.CW, plain_lookup, all_valid=av,
                                   ops=ST.PLAIN_OPS)(eng.tables, packed)
        assert torch.equal(got[0], want[0])
        for name_, args, out in calls:
            n = int(args[1][0]) if name_ == "minimizer_ranks" else int(args[5][0])
            plain = getattr(ST.PLAIN_OPS, name_)(*args)
            outs = out.values() if isinstance(out, dict) else out
            wants = plain.values() if isinstance(plain, dict) else plain
            for g, w in zip(outs, wants):
                assert torch.equal(g[:n], w[:n]), name_


@pytest.mark.cuda
def test_engine_on_a_second_card_launches_there(card, tmp_path):
    """An engine and its stream on cuda:1 while cuda:0 is current: every
    kernel launches on card 1 and equals its plain version. Waits for a
    machine with two cards (skips on one)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    idx = synthetic.small_index("m13_canonical")
    torch.cuda.set_device(0)
    eng = TorchEngine(idx, "cuda:1")
    kt = eng.kmers32(synthetic.query_batch(idx)[0])
    got = eng.lookup_device(kt)
    want = E.lookup_plain(eng.cfg, eng.tables, kt, None, "full")
    assert all(torch.equal(got[key], want[key]) for key in want)
    ids = torch.arange(idx.num_kmers, dtype=torch.int32, device="cuda:1")
    assert torch.equal(eng.access_device(ids), E.access_plain(eng.cfg, eng.tables, ids))
    path = _stream_reads(idx, np.random.default_rng(2), str(tmp_path))
    s = ST._DeviceStream(eng, idx.k, pmax=1 << 14, rmax_shift=6)
    for seq in ST.parse_reads(path):
        s.add_read(seq)
    assert s.finalize() == ST.host_report(idx, path)
    assert torch.cuda.current_device() == 0
