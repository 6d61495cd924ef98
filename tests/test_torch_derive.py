"""The stream's derive stages and scans (plain versions, on the CPU)
against the JAX package's definitions: the round-2 lanes against JAX's
segmented broadcast (streaming.py:541-545, 598-601: seg = prefix_sum_ex(head)
+ head - 1, round2 = need & ~head & head_mf[seg]), prefix_sum_ex and the
compaction against JAX's prefix_sum_ex and np.nonzero at the edges of the
kernels' tiles, and whole stream reports on reads that make one run over a
whole chunk (a poly-A read, a periodic read whose minimizer is found)
against JAX's jitted step on every chunk, its device stream and the host
_Batcher, with the run-skip forced on and off. The kernels themselves are
held to these plain versions on the card (tests/test_torch_kernels.py).
Outputs are integers: the tolerance is 0."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sshash_tpu
from sshash_tpu import streaming as JS
from sshash_tpu.engine import make_lookup as jax_make_lookup
from sshash_tpu.ops import packed as JP
from sshash_tpu_torch import TorchEngine, kernels, synthetic
from sshash_tpu_torch import streaming as ST
from sshash_tpu_torch.ops import packed as P
from test_torch_host import jax_index
from one_thread import one_torch_thread  # noqa: F401

P_RANKS = 2048


def jax_round2(head, found, mfound, n):
    """JAX's round-2 lanes in rank space (the lanes j < n need a lookup)."""
    Pn = head.shape[0]
    need = np.arange(Pn) < n
    hd = head & need
    hi = hd.astype(np.int32)
    seg = np.asarray(JP.prefix_sum_ex(jnp.asarray(hi))) + hi - 1
    head_mf = np.zeros(Pn, dtype=bool)
    head_mf[seg[hd]] = (found | mfound)[hd]
    return need & ~hd & head_mf[np.clip(seg, 0, Pn - 1)]


def round2_case(case, rng):
    """head, found, minimizer_found (bool (P,)) and n: heads below n only
    where the step makes them (rank 0 whenever n > 0), garbage past n."""
    n = {"random": int(rng.integers(1, P_RANKS)), "n0": 0, "n1": 1}.get(case, P_RANKS)
    head = rng.random(P_RANKS) < {"one_run": 0.0, "one_run_miss": 0.0, "all_heads": 1.1}.get(
        case, 0.2)
    head[n:] = rng.random(P_RANKS - n) < 0.5
    head[0] |= n > 0
    found = rng.random(P_RANKS) < 0.3
    mfound = rng.random(P_RANKS) < 0.5
    if case.startswith("one_run"):
        found[0] = False
        mfound[0] = case == "one_run"
    return head, found, mfound, n


@pytest.mark.parametrize("case", ["random", "one_run", "one_run_miss", "n0", "n1", "nP",
                                  "all_heads"])
def test_round2_plain_equals_jax_definition(case):
    head, found, mfound, n = round2_case(case, np.random.default_rng(len(case)))
    t = {k: torch.from_numpy(v) for k, v in (("h", head), ("f", found), ("m", mfound))}
    count = torch.tensor([n], dtype=torch.int32)
    got = ST.stream_round2_plain(t["h"], t["f"], t["m"], count)
    want = jax_round2(head, found, mfound, n)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert torch.equal(ST.stream_round2(t["h"], t["f"], t["m"], count), got)
    if case == "one_run":
        assert int(got.sum()) == P_RANKS - 1
    if case in ("one_run_miss", "all_heads", "n0", "n1"):
        assert not got.any()


def _sizes(tile):
    return [1, tile - 1, tile, tile + 1, 5 * tile + 7]


@pytest.mark.parametrize("n", _sizes(kernels.SCAN_TILE))
def test_prefix_sum_equals_jax_at_tile_edges(n):
    """Sums that wrap 2^32; a slice that starts off 16 bytes (as the step's
    per-read counts do)."""
    rng = np.random.default_rng(n)
    v = rng.integers(-(1 << 31), 1 << 31, n + 3, dtype=np.int64).astype(np.int32)
    v[::2] = rng.integers(1 << 30, 1 << 31, (n + 4) // 2)  # running sums pass 2^32
    for lo in (0, 2, 3):
        x = v[lo:lo + n]
        want = np.asarray(JP.prefix_sum_ex(jnp.asarray(x)))
        t = torch.from_numpy(v)[lo:lo + n]
        assert np.array_equal(P.prefix_sum_ex(t).numpy(), want), lo
        assert np.array_equal(P.scan_ex(t).numpy(), want), lo


@pytest.mark.parametrize("fill", ["random", "all", "none"])
@pytest.mark.parametrize("n", _sizes(kernels.COMPACT_TILE))
def test_compaction_equals_nonzero_at_tile_edges(n, fill):
    """Flags of any nonzero value count as set; zeros past the count."""
    rng = np.random.default_rng(n)
    flags = {"random": rng.integers(0, 256, n) * (rng.random(n) < 0.3),
             "all": rng.integers(1, 256, n), "none": np.zeros(n)}[fill].astype(np.uint8)
    lanes = np.nonzero(flags)[0]
    for fn in (P.compact_plain, P.compact):
        idx, cnt = fn(torch.from_numpy(flags))
        assert idx.dtype == torch.int32 and idx.shape == (n,) and int(cnt[0]) == len(lanes)
        assert np.array_equal(idx.numpy()[: len(lanes)], lanes)
        assert not idx.numpy()[len(lanes):].any()


# the poly-read stream: one index, one chunk shape, JAX compiled once
CONFIG, PMAX, RSHIFT = "k15", 1 << 12, 4
PERIOD = "AAAAAAC"  # k15 m7: every kmer's minimizer pair the same, found in the index


class _JaxStream(JS._DeviceStream):
    """JAX's device stream at one fixed shape, chunks recorded."""

    def _init_host(self, *args):
        super()._init_host(*args)
        self._no_ladder = True
        self._pipe = None
        self._capture = []


@pytest.fixture(scope="module")
def poly(tmp_path_factory):
    idx = synthetic.small_index(CONFIG)
    rng = np.random.default_rng(15)
    strings = synthetic.index_strings(idx)
    long_len = 2 * PMAX + 3 * idx.k
    reads = synthetic.cut_reads(strings, 40, 60, rng, rc=0.5) + synthetic.random_reads(
        40, 60, rng)
    reads += [b"A" * (3 * PMAX), (PERIOD.encode() * long_len)[:long_len]]
    path = os.path.join(tmp_path_factory.mktemp("poly"), "reads.fq")
    synthetic.write_reads(path, [reads[i] for i in rng.permutation(len(reads))])
    jd = sshash_tpu.Dictionary(jax_index(idx))
    jeng = jd.to_device()
    R = max(16, PMAX >> RSHIFT)
    CW = JS._DeviceStream._cw_words(PMAX, R, idx.k)
    full = jax.jit(JS.make_stream_step(jeng.cfg, jax_make_lookup(jeng.cfg), PMAX, R,
                                       packed_cw=CW))
    o2 = 2 + R + R // 32 + 1

    def all_valid_as_full(arrs, buf):
        buf = np.asarray(buf)
        vb = np.packbits(np.arange(PMAX // 32 * 32 + 32) < int(buf[0]),
                         bitorder="little").view(np.uint32)
        return full(arrs, np.concatenate([buf[:o2], vb, buf[o2:]]))

    jeng._stream_steps = {(PMAX, R): full, (PMAX, R, "av"): all_valid_as_full}
    js = _JaxStream(jeng, idx.k, pmax=PMAX, rmax_shift=RSHIFT)
    for seq in JS.parse_reads(path):
        js.add_read(seq)
    jrep = js.finalize()
    return idx, path, jrep, js._capture, jeng


def test_poly_reads_make_chunk_long_runs(poly):
    """With the run-skip on, a chunk inside the poly-A read is one run whose
    head misses its minimizer (no round 2), and a chunk inside the periodic
    read one run whose head finds it (every other rank in round 2)."""
    idx, path, _, _, _ = poly
    eng = TorchEngine(idx, "cpu")
    s = ST._DeviceStream(eng, idx.k, pmax=PMAX, rmax_shift=RSHIFT, runskip=True)
    s.capture = []
    for seq in ST.parse_reads(path):
        s.add_read(seq)
    s.finalize()
    runs = set()
    for av, packed in s.capture:
        stats = {}
        s._steps[av](eng.tables, packed, stats)
        need, heads, r2 = (int(stats[key]) for key in ("need", "heads", "round2"))
        if need == PMAX and heads == 1:
            runs.add("found" if r2 == PMAX - 1 else "missed" if r2 == 0 else "?")
    assert runs == {"found", "missed"}


@pytest.mark.parametrize("runskip", [None, True, False])
def test_poly_stream_equals_jax_and_host(poly, runskip):
    """Every chunk's (3, 4) equals JAX's jitted step on the same buffer; the
    report equals JAX's device stream and the host _Batcher."""
    idx, path, jrep, chunks, jeng = poly
    eng = TorchEngine(idx, "cpu")
    s = ST._DeviceStream(eng, idx.k, pmax=PMAX, rmax_shift=RSHIFT, runskip=runskip)
    full = jeng._stream_steps[(s.P, s.R)]
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
    assert rep["num_positive_kmers"] > 0
