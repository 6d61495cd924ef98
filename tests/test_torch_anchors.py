"""The stream's anchor stage (streaming.stream_anchors: segment and read
starts, the group scan and the anchors' kmers in one kernel launch), the
misses' kmer read and the K7 read over the interleaved table.

On the CPU: the fused plain stage equals the composition it replaced
(stream_masks_plain, prefix_sum_ex of the group counts, the anchors' kmer
read) field for field, and so does a NumPy model of the kernel's own
design (a thread a group of 16 lanes: a binary search of pstart, a walk
of at most 16 reads, the two halves of a bit word paired), on chunks
with reads
of exactly k chars, a read longer than P split into segments, a start at
lane P-1, starts in the last group only, nreads of 0 and of R, and real
chunks packed by _DeviceStream. On the card (`cuda`): the kernels equal
their plain versions bit for bit at W = 1..16.

This file imports no JAX; the JAX step's masks stage is held to the fused
stage in tests/test_torch_streaming.py. Outputs are integers: tolerance 0.
"""

import numpy as np
import pytest
import torch

from sshash_tpu_torch import TorchEngine, kernels, synthetic
from sshash_tpu_torch import streaming as ST
from sshash_tpu_torch.ops import packed as P
from sshash_tpu_torch.ops import u64 as u
from one_thread import one_torch_thread  # noqa: F401

PL, RL = 512, 64  # a synthetic chunk's lanes and read budget
CASES = synthetic.STREAM_CHUNK_CASES
# k at every kernel width W = 1..16 (the last word full), and last words
# cut short at the fixed widths and the runtime-width form
KS = [16 * w - 1 for w in range(1, 17)] + [9, 21, 40, 65, 129, 200]
CONFIG_OF = {15: "k15", 31: "m13_regular", 65: "k65"}  # small indexes at the CPU tests' k


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _chunk(case, k, rng, Pn=PL, R=RL):
    return synthetic.stream_chunk(case, k, rng, Pn, R)


def _stream_chunks(k):
    """Real chunks of 512 lanes packed by _DeviceStream (its steps not
    run): short reads of k to k + 40 chars around a read of more than 2P
    positions, which splits into exact-P segments."""
    rng = np.random.default_rng(k)
    reads = [bytes(rng.choice(list(b"ACGT"), int(rng.integers(k, k + 40)))) for _ in range(60)]
    reads.insert(17, bytes(rng.choice(list(b"ACGT"), 2 * PL + 3 * k)))
    eng = TorchEngine(synthetic.small_index(CONFIG_OF[k]), "cpu")
    s = ST._DeviceStream(eng, k, pmax=PL, rmax_shift=3)
    s._run = lambda all_valid, packed: None
    s.capture = []
    for seq in reads:
        s.add_read(seq)
    s.flush()
    o0, o1, o2, o3 = ST.packed_offsets(s.P, s.R)
    out = []
    for av, packed in s.capture:
        words = packed[o2:o2 + s.CW] if av else packed[o3:o3 + s.CW]
        out.append((P.prefix_sum_ex(packed[o0:o1]), packed[o1:o2], packed[1:2], words))
    assert len(out) >= 3
    return s.P, out


def _composition(pstart, rfirst, nreads, words32, Pn, k):
    """The stages the fused one replaced, as the step ran them."""
    sbits, fbits, gcnt = ST.stream_masks_plain(pstart, rfirst, nreads, Pn)
    cum_g = P.prefix_sum_ex(gcnt)
    apos = ST.lane_positions(torch.arange(Pn // 16) * 16, sbits, cum_g, k)
    return sbits, fbits, cum_g, u.to_i32(P.read_kmers_at(u.u32(words32), apos, k))


def _by_search(pstart, rfirst, nreads, words32, Pn, k):
    """The anchors kernel's design in NumPy, thread by thread: the thread of
    group g (of A + 2, the bit arrays' last word included) finds the reads
    before lane 16g by a binary search of pstart[:nreads] in power-of-two
    steps; it walks at most 16 reads from there into its 16-bit halves,
    which pair into words; groups below A write their scan entry and read
    their anchor's kmer."""
    ps = pstart.numpy().view(np.uint32)
    rf = rfirst.numpy().view(np.uint32)
    nr = min(int(nreads[0]), ps.shape[0])
    A = Pn // 16
    sh, fh = np.zeros(A + 2, np.uint32), np.zeros(A + 2, np.uint32)
    cum = np.zeros(A, np.int64)
    for g in range(A + 2):
        v, a = 16 * g, 0
        step = 1 << (nr.bit_length() - 1) if nr else 0
        while step:
            if a + step <= nr and ps[a + step - 1] < v:
                a += step
            step >>= 1
        for r in range(a, min(nr, a + 16)):
            d = int(ps[r]) - v
            if d >= 16:
                break
            sh[g] |= 1 << d
            fh[g] |= ((int(rf[r >> 5]) >> (r & 31)) & 1) << d
        if g < A:
            cum[g] = a
    g = np.arange(A)
    r = cum + (sh[:A] & 1) - 1
    apos = torch.from_numpy((16 * g + r * (k - 1)) & 0xFFFFFFFF)
    pair = lambda h: torch.from_numpy(  # noqa: E731
        (h[0::2].astype(np.int64) | (h[1::2].astype(np.int64) << 16)))
    return (u.to_i32(pair(sh)), u.to_i32(pair(fh)), torch.from_numpy(cum).to(torch.int32),
            u.to_i32(P.read_kmers_at(u.u32(words32), apos, k)))


def _equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), ("sbits", "fbits", "cum_g", "kmers")[i]


@pytest.mark.parametrize("k", [15, 31, 65])
@pytest.mark.parametrize("case", CASES)
def test_fused_plain_equals_the_composition_and_the_kernel_design(case, k):
    rng = np.random.default_rng(CASES.index(case) * 1000 + k)
    args = _chunk(case, k, rng)
    got = ST.stream_anchors_plain(*args, PL, k)
    _equal(got, _composition(*args, PL, k))
    _equal(got, _by_search(*args, PL, k))
    A = PL // 16
    assert got[3].shape == (A, P.num_words32(k))
    if case == "exact_k":  # 64 starts: groups 0-3 full
        assert got[2].tolist()[:5] == [0, 16, 32, 48, 64]
    if case == "last_lane":
        assert (int(u.u32(got[0])[PL // 32 - 1]) >> 31) & 1
    if case == "last_group":
        assert got[2].tolist() == [0] + [1] * (A - 1)
        assert int(u.u32(got[0])[PL // 32 - 1]) >> 16 == (1 << 6) | (1 << 9) | (1 << 12)
    if case == "n0":
        assert not got[0].any() and not got[1].any() and not got[2].any()


@pytest.mark.parametrize("k", [15, 31, 65])
def test_fused_plain_on_packed_chunks(k):
    """_DeviceStream's own chunks (a long read split into exact-P
    segments among short reads): plain == composition == the kernel's
    design, and every chunk's reads have at least one position."""
    Pn, chunks = _stream_chunks(k)
    for args in chunks:
        n = int(args[2][0])
        assert (torch.diff(args[0][:n].to(torch.int64)) >= 1).all()
        got = ST.stream_anchors_plain(*args, Pn, k)
        _equal(got, _composition(*args, Pn, k))
        _equal(got, _by_search(*args, Pn, k))


def test_kmers_plain_reads_rows_below_the_count():
    """Rows below the count (clamped to [0, n_out]) read their lanes' kmers
    (a compacted list: rising lanes in runs and gaps, zeros past it); the
    rest are zero."""
    rng = np.random.default_rng(5)
    k = 31
    pstart, rfirst, nreads, words = _chunk("random", k, rng)
    sbits, _, cum_g, _ = ST.stream_anchors_plain(pstart, rfirst, nreads, words, PL, k)
    lanes = synthetic.miss_lanes(rng, PL, 300)
    full = ST.stream_kmers_plain(words, sbits, cum_g, k, lanes, torch.tensor([PL]))
    want = u.to_i32(P.read_kmers_at(u.u32(words), ST.lane_positions(lanes.to(torch.int64), sbits,
                                                                     cum_g, k), k))
    assert torch.equal(full, want)
    for n in (-3, 0, 1, 31, 32, PL, PL + 9):
        got = ST.stream_kmers_plain(words, sbits, cum_g, k, lanes, torch.tensor([n],
                                                                               dtype=torch.int32))
        m = min(max(n, 0), PL)
        assert torch.equal(got[:m], full[:m]) and not got[m:].any()


@pytest.mark.parametrize("P, m", [(512, 0), (512, 1), (512, 31), (512, 300), (512, 512),
                                  (1 << 14, 257)])
def test_miss_lanes_is_a_compacted_list(P, m):
    """synthetic.miss_lanes, the misses' lane lists of the card tests and
    chip_smoke: m distinct rising lanes of [0, P), zeros past them, in runs
    of adjacent lanes with gaps between wherever m leaves room."""
    lanes = synthetic.miss_lanes(np.random.default_rng(m), P, m).numpy()
    assert lanes.shape == (P,) and lanes.dtype == np.int32 and not lanes[m:].any()
    d = np.diff(lanes[:m])
    assert (d >= 1).all() and lanes[:m].min(initial=0) >= 0 and lanes[:m].max(initial=0) < P
    if m == P:
        assert (lanes == np.arange(P)).all()
    if 31 <= m < P:
        assert (d == 1).any() and (d > 1).any()


def test_debug_step_refuses_a_read_without_positions(monkeypatch):
    """With SSHASH_DEBUG=1 the stream step checks the anchors kernel's
    precondition on each packed buffer: _DeviceStream's own chunk passes,
    the same chunk with a read of no positions raises."""
    monkeypatch.setenv("SSHASH_DEBUG", "1")
    eng = TorchEngine(synthetic.small_index("k15"), "cpu")
    rng = np.random.default_rng(3)
    s = ST._DeviceStream(eng, 15, pmax=PL, rmax_shift=3)
    s._run = lambda all_valid, packed: None
    s.capture = []
    for _ in range(20):
        s.add_read(bytes(rng.choice(list(b"ACGT"), int(rng.integers(15, 60)))))
    s.flush()
    av, packed = s.capture[0]
    step = ST.make_stream_step(eng.cfg, s.P, s.R, s.CW, ST.make_lookup(eng.cfg, "full"),
                               all_valid=av)
    step(eng.tables, packed)
    bad = packed.clone()
    bad[ST.packed_offsets(s.P, s.R)[0] + int(packed[1]) - 1] = 0
    with pytest.raises(ValueError, match="rnpos"):
        step(eng.tables, bad)


# ---------------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
def test_anchors_kernel_equals_plain_on_card(card, k):
    """Every case at 512 lanes, and a random chunk of 2^16 lanes (257
    blocks), bit for bit; the kernel writes every word it returns."""
    rng = np.random.default_rng(k)
    for case, Pn, R in [(c, PL, RL) for c in CASES] + [("random", 1 << 16, 1 << 12)]:
        args = [a.to(card) for a in _chunk(case, k, rng, Pn, R)]
        before = kernels.stream_anchors_kernel.launches
        got = ST.stream_anchors(*args, Pn, k)
        assert kernels.stream_anchors_kernel.launches == before + 1
        want = ST.stream_anchors_plain(*args, Pn, k)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (case, Pn)


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
def test_misses_read_equals_plain_on_card(card, k):
    """The misses' read on its card-sized grid at counts 0, 1, 31, 32, 257,
    P/2 and P, each over a lane list as the compaction leaves it (that
    many rising lanes in runs and gaps, zeros past them): rows below the
    count equal the plain version's."""
    rng = np.random.default_rng(k + 1)
    Pn = 1 << 14
    pstart, rfirst, nreads, words = (a.to(card) for a in _chunk("random", k, rng, Pn, 1 << 10))
    sbits, _, cum_g, _ = ST.stream_anchors(pstart, rfirst, nreads, words, Pn, k)
    for n in (0, 1, 31, 32, 257, Pn // 2, Pn):
        lanes = synthetic.miss_lanes(rng, Pn, n).to(card)
        count = torch.tensor([n], dtype=torch.int32, device=card)
        got = ST.stream_kmers(words, sbits, cum_g, k, lanes, count)
        want = ST.stream_kmers_plain(words, sbits, cum_g, k, lanes, count)
        assert torch.equal(got[:n], want[:n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
def test_read_at2_equals_plain_on_card(card, k):
    """K7 over a random interleaved table, offsets in its last rows (reads
    clip) and past its end, at batch sizes off the block and the 16-byte
    store: bit for bit."""
    rng = np.random.default_rng(k + 2)
    n = 4096
    table = torch.from_numpy(rng.integers(0, 1 << 32, (n, 2), dtype=np.uint64).astype(
        np.uint32).view(np.int32)).to(card)
    for B in (1, 3, 255, 257, 4099):
        offs = rng.integers(16 * (n - P.num_words32(k) - 2), 16 * n + 64, B).astype(np.uint32)
        offs[: B // 2] = rng.integers(0, 16 * n, B // 2)
        ot = torch.from_numpy(offs.view(np.int32)).to(card)
        got, want = P.read_kmers_at2(table, ot, k), P.read_kmers_at2_plain(table, ot, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), B
