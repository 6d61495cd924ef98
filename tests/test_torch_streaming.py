"""The port's streaming (plain step on the CPU) against the JAX package's:
its device helpers (prefix_sum_ex, char_mmer_hashes, sliding_min_u64),
the run-skip's minimizer pair against kernel 1's plain version, every
chunk's (3, 4) against JAX's jitted step on the same packed buffer, and
whole reports against JAX's device stream and the host _Batcher.

JAX compiles its step once per configuration, at one (P, R) = (2^16,
2^8): every read set here streams with rmax_shift 8, JAX's stream runs
with its shape ladder off (the ladder only picks smaller shapes for the
same function), and its all-valid variant is served by its full step on
the buffer with the valid bits written out, which is what the all-valid
step derives on the device."""

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
from sshash_tpu.ops import u64 as JU
from sshash_tpu_torch import Dictionary, TorchEngine, native, synthetic
from sshash_tpu_torch import streaming as ST
from sshash_tpu_torch.ops import packed as P
from sshash_tpu_torch.ops import u64 as u
from test_torch_host import jax_index
from one_thread import one_torch_thread  # noqa: F401

CHUNK, RSHIFT = 1 << 16, 8
CONFIGS = ("m13_regular", "m13_canonical", "k15")
READ_SETS = ("genome", "lowhit", "mixed")


def _u64(pair):
    return (pair.hi.numpy().astype(np.uint64) << np.uint64(32)) | pair.lo.numpy().astype(np.uint64)


def _ju64(pair):
    hi, lo = np.asarray(pair.hi), np.asarray(pair.lo)
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def test_scan_and_hash_ops_equal_jax():
    rng = np.random.default_rng(0)
    for n in (1, 16, 1000, 4096 + 7):
        v = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)
        want = np.asarray(JP.prefix_sum_ex(jnp.asarray(v)))
        assert np.array_equal(P.prefix_sum_ex(torch.from_numpy(v)).numpy(), want), n
        assert np.array_equal(P.scan_ex(torch.from_numpy(v)).numpy(), want), n
    flags = (rng.random(5000) < 0.3).astype(np.uint8)
    idx, cnt = P.compact(torch.from_numpy(flags))
    lanes = np.nonzero(flags)[0]
    assert int(cnt[0]) == len(lanes)
    assert np.array_equal(idx.numpy()[: len(lanes)], lanes) and not idx.numpy()[len(lanes):].any()
    words = rng.integers(0, 1 << 32, 300, dtype=np.uint64).astype(np.uint32)
    magic = int(rng.integers(0, 1 << 63))
    for m in (7, 13, 25):
        C = len(words) * 16
        hf, hr = P.char_mmer_hashes(torch.from_numpy(words.astype(np.int64)), C, m, magic)
        jf, jr = JP.char_mmer_hashes(jnp.asarray(words), C, m, JU.const64(magic))
        assert np.array_equal(_u64(hf), _ju64(jf)) and np.array_equal(_u64(hr), _ju64(jr)), m
        for w in (1, 9, 19, 39):
            got = _u64(P.sliding_min_u64(hf, w))
            assert np.array_equal(got, _ju64(JP.sliding_min_u64(jf, w))), (m, w)


@pytest.mark.parametrize("k,m", [(15, 7), (31, 13), (63, 25)])
def test_runskip_pair_is_kernel1_minimizer(k, m):
    """At every valid lane, the run-skip's pair (sliding minimum of the
    per-char m-mer hashes, both strands, at the lane's position) is the
    mixer hash of kernel 1's (mv_f, mv_r) for the kmer there, so comparing
    kernel 1's pairs compares JAX's (the mixer is a bijection)."""
    rng = np.random.default_rng(k)
    reads = synthetic.with_n(synthetic.random_reads(200, 2 * k + 40, rng), 0.5, rng)
    lens = np.array([len(r) for r in reads], dtype=np.int64)
    cstarts = np.cumsum(lens) - lens
    npos = lens - k + 1
    words = np.zeros((lens.sum() + 15) // 16 + 4, dtype=np.uint32)
    valid_bits = np.zeros(npos.sum() // 32 + 1, dtype=np.uint32)
    assert native.encode_stream(b"".join(reads), cstarts, lens, k, words, valid_bits) == npos.sum()
    pos = np.concatenate([c + np.arange(n) for c, n in zip(cstarts, npos)])
    valid = (valid_bits[np.arange(len(pos)) >> 5] >> (np.arange(len(pos)) & 31)) & 1 != 0
    assert 0 < valid.sum() < len(valid)
    magic = int(rng.integers(0, 1 << 63))
    w32 = torch.from_numpy(words.astype(np.int64))
    hf, hr = P.char_mmer_hashes(w32, len(words) * 16, m, magic)
    mh_f, mh_r = (_u64(P.sliding_min_u64(h, k - m + 1))[pos] for h in (hf, hr))
    km = u.to_i32(P.read_kmers_at(w32, torch.from_numpy(pos), k))
    mv_f, _, _, mv_r, _ = P.minimizer_plain(km, k, m, magic, both=True)
    for mh, mv in ((mh_f, mv_f), (mh_r, mv_r)):
        h = _u64(u.mixer64(u.from_i64(mv), magic))
        assert np.array_equal(h[valid], mh[valid])


def _read_sets(idx, tmp, rng):
    """genome (multiline, long enough that a read splits across chunks),
    low-hit reads (FASTQ, 1% with an N) and mixed reads (FASTQ, half cut
    from the strings with RC and 1% substitutions, half random)."""
    strings = synthetic.index_strings(idx)
    reps = -(-3 * CHUNK // 2 // sum(len(s) for s in strings))
    paths = {"genome": os.path.join(tmp, "genome.fa"), "lowhit": os.path.join(tmp, "low.fq"),
             "mixed": os.path.join(tmp, "mixed.fq")}
    synthetic.write_genome(paths["genome"], strings * reps, rng)
    low = synthetic.cut_reads(strings, 12, 76, rng) + synthetic.random_reads(1200, 76, rng)
    synthetic.write_reads(paths["lowhit"], synthetic.with_n(
        [low[i] for i in rng.permutation(len(low))], 0.01, rng))
    L = min(150, max(len(s) for s in strings))
    mixed = (synthetic.cut_reads(strings, 300, L, rng, rc=0.5, subst=0.01)
             + synthetic.random_reads(300, L, rng))
    synthetic.write_reads(paths["mixed"], [mixed[i] for i in rng.permutation(len(mixed))])
    return paths


class _JaxStream(JS._DeviceStream):
    """JAX's device stream at one fixed shape, chunks recorded."""

    def _init_host(self, *args):
        super()._init_host(*args)
        self._no_ladder = True
        self._pipe = None
        self._capture = []


@pytest.fixture(scope="module", params=CONFIGS)
def case(request, tmp_path_factory):
    idx = synthetic.small_index(request.param)
    jd = sshash_tpu.Dictionary(jax_index(idx))
    jeng = jd.to_device()
    Pn, R = CHUNK, max(16, CHUNK >> RSHIFT)
    CW = JS._DeviceStream._cw_words(Pn, R, idx.k)
    full = jax.jit(JS.make_stream_step(jeng.cfg, jax_make_lookup(jeng.cfg), Pn, R, packed_cw=CW))
    o2 = 2 + R + R // 32 + 1

    def all_valid_as_full(arrs, buf):
        buf = np.asarray(buf)
        cnt = int(buf[0])
        vb = np.packbits(np.arange(Pn // 32 * 32 + 32) < cnt, bitorder="little").view(np.uint32)
        return full(arrs, np.concatenate([buf[:o2], vb, buf[o2:]]))

    jeng._stream_steps = {(Pn, R): full, (Pn, R, "av"): all_valid_as_full}
    paths = _read_sets(idx, str(tmp_path_factory.mktemp(request.param)),
                       np.random.default_rng(len(request.param)))
    return request.param, idx, jeng, paths, (Pn, R, CW)


def _jax_stream(jeng, k, path, multiline):
    s = _JaxStream(jeng, k, pmax=CHUNK, rmax_shift=RSHIFT)
    for seq in JS.parse_reads(path, multiline=multiline):
        s.add_read(seq)
    return s.finalize(), s._capture


def _rows_equal(got, want):
    """Counters exactly; lane rows' found flag exactly and the rest where
    it is set (JAX's branches leave other values on unfound lanes)."""
    assert np.array_equal(got[0], want[0]), (got, want)
    for i in (1, 2):
        assert got[i, 0] == want[i, 0], (got, want)
        if want[i, 0]:
            assert np.array_equal(got[i], want[i]), (got, want)


@pytest.mark.parametrize("reads", READ_SETS)
def test_stream_equals_jax_and_host(case, reads):
    """Per chunk, the port's plain step equals JAX's jitted step on the same
    packed buffer; the whole report equals JAX's device stream and the
    host _Batcher, through streaming_query_from_file on the CPU."""
    _, idx, jeng, paths, (Pn, R, CW) = case
    path, ml = paths[reads], reads == "genome"
    jrep, chunks = _jax_stream(jeng, idx.k, path, ml)
    assert len(chunks) >= 2
    eng = TorchEngine(idx, "cpu")
    lookup = ST.make_lookup(eng.cfg, "full")
    steps = {av: ST.make_stream_step(eng.cfg, Pn, R, CW, lookup, all_valid=av)
             for av in (False, True)}
    for fn, jbuf in chunks:
        av = fn is not jeng._stream_steps[(Pn, R)]
        buf = torch.from_numpy(np.array(jbuf).view(np.int32))
        got = steps[av](eng.tables, buf).numpy().view(np.uint32)
        _rows_equal(got, np.asarray(fn(jeng.arrs, jbuf)))
    rep = ST.streaming_query_from_file(Dictionary(idx), path, multiline=ml, device="cpu",
                                       chunk=CHUNK, rmax_shift=RSHIFT)
    assert rep.pop("elapsed_millisec") >= 0
    assert rep == jrep == ST.host_report(idx, path, multiline=ml)
    if reads == "lowhit":
        assert rep["num_positive_kmers"] > 0 and rep["num_invalid_kmers"] > 0


@pytest.mark.parametrize("reads", READ_SETS)
def test_anchor_stage_gives_the_jax_masks_sum(case, reads):
    """On every chunk, the fused anchor stage's outputs give the sum that
    JAX's step returns at debug_stage="masks" (streaming.py:380-383: the
    anchors' char positions and the valid, read-start and segment-start
    bits of the P lanes), and its anchor kmers are the kmers at those
    positions."""
    _, idx, jeng, paths, (Pn, R, CW) = case
    masks = jax.jit(JS.make_stream_step(jeng.cfg, jax_make_lookup(jeng.cfg), Pn, R,
                                        packed_cw=CW, debug_stage="masks"))
    s = ST._DeviceStream(TorchEngine(idx, "cpu"), idx.k, pmax=Pn, rmax_shift=RSHIFT)
    s._run = lambda all_valid, packed: None  # the chunks alone
    s.capture = []
    for seq in ST.parse_reads(paths[reads], multiline=reads == "genome"):
        s.add_read(seq)
    s.flush()
    assert len(s.capture) >= 2
    o0, o1, o2, o3 = ST.packed_offsets(Pn, R)
    lanes = torch.arange(Pn // 16) * 16

    def bits(b):  # set bits of lanes < P
        return int(np.bitwise_count(np.asarray(b, dtype=np.uint32)[: Pn // 32]).sum())

    for av, packed in s.capture:
        buf = packed.numpy().view(np.uint32)
        if av:  # the valid bits written out, as the all-valid step derives them
            vb = np.packbits(np.arange(Pn // 32 * 32 + 32) < int(buf[0]),
                             bitorder="little").view(np.uint32)
            buf = np.concatenate([buf[:o2], vb, buf[o2:]])
        words32 = torch.from_numpy(buf[o3:o3 + CW].view(np.int32))
        sbits, fbits, cum_g, akm = ST.stream_anchors(P.prefix_sum_ex(packed[o0:o1]),
                                                     packed[o1:o2], packed[1:2], words32, Pn,
                                                     idx.k)
        apos = ST.lane_positions(lanes, sbits, cum_g, idx.k)
        got = (int(apos.sum()) + bits(buf[o2:o3]) + bits(u.u32(fbits).numpy())
               + bits(u.u32(sbits).numpy())) & 0xFFFFFFFF
        assert got == int(np.asarray(masks(jeng.arrs, buf))[0, 0])
        assert torch.equal(akm, u.to_i32(P.read_kmers_at(u.u32(words32), apos, idx.k)))


def test_runskip_forced_on_and_off_gives_the_same_report(case):
    _, idx, _, paths, _ = case
    eng = TorchEngine(idx, "cpu")
    reps, skipped = [], []
    for runskip in (None, True, False):
        s = ST._DeviceStream(eng, idx.k, pmax=CHUNK, rmax_shift=RSHIFT, runskip=runskip)
        s.capture = []
        for seq in ST.parse_reads(paths["lowhit"]):
            s.add_read(seq)
        reps.append(s.finalize())
        stats = {}
        av, packed = s.capture[0]
        s._steps[av](eng.tables, packed, stats)
        skipped.append(int(stats["need"]) - int(stats["heads"]) - int(stats["round2"]))
    assert reps[0] == reps[1] == reps[2]
    assert skipped[0] == skipped[1] > 0 and skipped[2] == 0


def test_streaming_defaults_to_the_card():
    """streaming_query_from_file and the engines take the card unless told
    otherwise; without one the call fails instead of falling back."""
    import inspect

    for fn in (ST.streaming_query_from_file, TorchEngine.__init__, Dictionary.to_device):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            TorchEngine(synthetic.small_index("k15"))
