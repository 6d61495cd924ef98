"""The stream chain (csrc/stream_chain.cu and streaming.stream_chain_plain)
on read sets made to reach every term of a follower's condition: backward
anchors within 15 chars of the index's first char (`under`, where the
follower's offset would wrap) and of their string's start, chains that run
on past a string's end into the next string's chars (`instr`), an N at each
of a group's 16 positions, reads shorter than k + 15 (a read start inside
a group), and a char mismatch at a follower on both strands.

On the CPU the port's stream report equals the JAX package's device stream
(JAX on the CPU) and the host _Batcher, and on every chunk's recorded chain
inputs the chain given string windows from stream_swin_plain over (1, 4)
word shards (their unsigned max) equals the chain that reads strings32. A
`cuda` test holds the chain kernel to its plain version on the same
chunks, in both forms, at anchor counts odd and below 16 (a half-filled
warp) as well as whole chunks; it needs no JAX, so the card runs it with
--noconftest. Outputs are integers: the tolerance is 0."""

import numpy as np
import pytest
import torch

from sshash_tpu_torch import Dictionary, TorchEngine, synthetic
from sshash_tpu_torch import engine as E
from sshash_tpu_torch import streaming as ST
from sshash_tpu_torch.layout import AccessShard
from sshash_tpu_torch.ops.u64 import to_i32, u32
from one_thread import one_torch_thread  # noqa: F401

CONFIGS = ("m13_regular", "m13_canonical")
PMAX, RSHIFT = 1 << 12, 4  # positions a chunk, R = P >> 4 reads


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def chain_reads(idx, rng):
    """Reads for every branch of the chain condition, shuffled."""
    k = idx.k
    strings = synthetic.index_strings(idx)
    rc = synthetic.revcomp_bytes
    reads = []
    for s in strings:
        # the reverse complement of a string's first chars: backward
        # anchors whose followers would start before the string (instr)
        reads += [rc(s[:int(n)]) for n in rng.integers(k, k + 40, 3)]
    # the same at the index's first chars, at every length: followers
    # before char 0 (under)
    reads += [rc(strings[0][:n]) for n in range(k, k + 48)]
    for a, b in zip(strings, strings[1:]):
        # one string's last chars, then the next string's first: the
        # followers' chars match strings32 past the anchor's string end
        r = a[-int(rng.integers(k, 2 * k)):] + b[:int(rng.integers(1, k))]
        reads += [r, rc(r)]
    # one N at a random place in exact reads; reads of k..k+14 chars;
    # substitutions on both strands
    reads += synthetic.with_n(synthetic.cut_reads(strings, 400, k + 60, rng, rc=0.5), 1.0, rng)
    for n in range(k, k + 15):
        reads += synthetic.cut_reads(strings, 12, n, rng, rc=0.5)
    reads += synthetic.cut_reads(strings, 300, k + 40, rng, rc=0.5, subst=0.03)
    return [reads[i] for i in rng.permutation(len(reads))]


def record_chains(eng, path):
    """Stream the reads at path through the port on eng's device; returns
    the report and each chunk's chain call (args, kwargs)."""
    calls = []

    def chain(*a, **kw):
        calls.append((a, kw))
        return ST.stream_chain(*a, **kw)

    s = ST._DeviceStream(eng, eng.cfg.k, pmax=PMAX, rmax_shift=RSHIFT)
    ops = ST.KERNEL_OPS._replace(chain=chain)
    s._steps = {av: ST.make_stream_step(eng.cfg, s.P, s.R, s.CW, E.make_lookup(eng.cfg, "full"),
                                        all_valid=av, ops=ops) for av in (False, True)}
    for seq in ST.parse_reads(path):
        s.add_read(seq)
    return s.finalize(), calls


def char_at(words, pos):
    """Char pos of packed words, the word index clipped as the chain's
    window reads clip it."""
    return (u32(words)[(pos >> 4).clamp(max=words.shape[0] - 1)] >> ((pos & 15) * 2)) & 3


def terms(ares, words32, strings32, valid_bits, sbits, fbits, cum_g, k):
    """Each follower's terms, (16, A) bool, read from the chain's inputs in
    the layout JAX's phase 2 uses (streaming.py:390-435 of the JAX
    package)."""
    A = ares["found"].shape[0]
    t = torch.arange(16)[:, None]
    bits = {n: ((ST._halves(b, A)[None, :] >> t) & 1) != 0
            for n, b in (("valid", valid_bits), ("first", fbits), ("start", sbits))}
    aoff, abeg, aend = (u32(ares[f]) for f in ("kmer_offset", "string_begin", "string_end"))
    fwd = (ares["kmer_orientation"] == 1).expand(16, A)
    og = torch.where(fwd, aoff + t, aoff - t) & 0xFFFFFFFF
    base = ST._window_base(aoff, fwd[0], k)
    apos = ST.lane_positions(torch.arange(A) * 16, sbits, cum_g, k)
    # the string char of follower t (its last forward, its first backward)
    # and the read char of lane t
    schar = char_at(strings32, torch.where(fwd, base + t, og))
    rchar = char_at(words32, apos + k - 1 + t)
    return dict(bits, fwd=fwd, anchor=(ares["found"] != 0).expand(16, A),
                under=~fwd & (aoff < t),
                instr=(og >= abeg) & (((og + k) & 0xFFFFFFFF) <= aend),
                charok=torch.where(fwd, schar == rchar, schar == (rchar ^ 2)))


def swin_over_shards(ares, strings32, k, parts=4):
    """The anchors' windows from stream_swin_plain on `parts` word shards
    of strings32 (each slice with its halo), combined by unsigned max."""
    n = strings32.shape[0]
    cut = [n * j // parts + (j > 0) for j in range(parts)] + [n]
    wins = [ST.stream_swin_plain(ares["kmer_offset"], ares["kmer_orientation"],
                                 strings32[lo:hi + 2], k, AccessShard(0, 0, lo, hi))
            for lo, hi in zip(cut, cut[1:])]
    return to_i32(torch.stack([u32(w) for w in wins]).amax(0))


@pytest.fixture(scope="module", params=CONFIGS)
def case(request, tmp_path_factory):
    idx = synthetic.small_index(request.param)
    path = str(tmp_path_factory.mktemp(request.param) / "reads.fq")
    synthetic.write_reads(path, chain_reads(idx, np.random.default_rng(len(request.param))))
    return request.param, idx, path


def test_chain_report_equals_jax_and_host(case):
    """The report through streaming_query_from_file on the CPU equals JAX's
    device stream at the same chunk shape and the host _Batcher; the
    chunks reach every term of the condition, each deciding where a chain
    stops; the chain's found lanes are the prefix-AND of the terms."""
    import sshash_tpu
    from sshash_tpu import streaming as JS

    from test_torch_host import jax_index

    name, idx, path = case

    class FixedShape(JS._DeviceStream):  # no shape ladder, no upload thread
        def _init_host(self, *args):
            super()._init_host(*args)
            self._no_ladder = True
            self._pipe = None

    js = FixedShape(sshash_tpu.Dictionary(jax_index(idx)).to_device(), idx.k, pmax=PMAX,
                    rmax_shift=RSHIFT)
    for seq in JS.parse_reads(path):
        js.add_read(seq)
    jrep = js.finalize()
    rep = ST.streaming_query_from_file(Dictionary(idx), path, device="cpu", chunk=PMAX,
                                       rmax_shift=RSHIFT)
    rep.pop("elapsed_millisec")
    assert rep == jrep == ST.host_report(idx, path), name
    rep2, calls = record_chains(TorchEngine(idx, "cpu"), path)
    assert rep2 == rep and len(calls) >= 2
    stops = {}
    for a, kw in calls:
        tm = terms(*a)
        cond = (tm["valid"] & ~tm["first"] & ~tm["start"] & tm["charok"] & tm["instr"]
                & ~tm["under"])
        cond[0] = tm["anchor"][0] & tm["valid"][0]
        held = torch.cumprod(cond.to(torch.int32), 0) > 0
        assert torch.equal(ST.stream_chain_plain(*a)["found"].reshape(-1, 16).t() != 0, held)
        # lane t ends a chain whose anchor and lanes 1..t-1 held
        ends = torch.zeros_like(held)
        ends[1:] = held[:-1] & ~held[1:]
        for term, where in (("under", tm["under"]), ("instr", ~tm["instr"]),
                            ("start", tm["start"]),
                            ("mismatch forward", ~tm["charok"] & tm["fwd"]),
                            ("mismatch backward", ~tm["charok"] & ~tm["fwd"])):
            stops[term] = stops.get(term, 0) + int((ends & where).sum())
        # the first invalid lane of a group whose anchor was found, at
        # each of the 16 positions (lane 0: an anchor that is invalid)
        valid = tm["valid"]
        first_bad = (torch.cumprod(valid.to(torch.int32), 0) == 0).to(torch.int32).argmax(0)
        lost = ~valid.all(0) & (tm["anchor"][0] | (first_bad == 0))
        for pos in first_bad[lost].unique().tolist():
            stops[f"N at {pos}"] = 1
    assert stops["under"] >= 10, stops
    missing = [term for term in ["under", "instr", "start", "mismatch forward",
                                 "mismatch backward"] + [f"N at {p}" for p in range(16)]
               if not stops.get(term)]
    assert not missing, (name, missing, stops)


def test_chain_given_windows_equals_chain(case):
    """On every chunk's chain inputs, the chain given the windows of (1, 4)
    word shards equals the chain that reads strings32."""
    name, idx, path = case
    _, calls = record_chains(TorchEngine(idx, "cpu"), path)
    for a, _ in calls:
        ares, words32, strings32, *rest = a
        want = ST.stream_chain_plain(*a)
        swin = swin_over_shards(ares, strings32, idx.k)
        got = ST.stream_chain_plain(ares, words32, None, *rest, swin=swin)
        for key in want:
            assert torch.equal(got[key], want[key]), (name, key)


def sliced(a, A):
    """The chain inputs of the first A anchors."""
    ares, words32, strings32, valid_bits, sbits, fbits, cum_g, k = a
    nb = A * 16 // 32 + 1
    return ({f: v[:A] for f, v in ares.items()}, words32, strings32, valid_bits[:nb],
            sbits[:nb], fbits[:nb], cum_g[:A], k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
def test_chain_kernel_equals_plain_on_card(card, name, tmp_path):
    """The chain kernel, reading strings32 and given windows, equals its
    plain version on every chunk and on its first A anchors for A = 1, 7,
    15 (one partial half-warp), 17 and 33."""
    idx = synthetic.small_index(name)
    path = str(tmp_path / "reads.fq")
    synthetic.write_reads(path, chain_reads(idx, np.random.default_rng(len(name))))
    _, calls = record_chains(TorchEngine(idx, "cpu"), path)
    for a, _ in calls:
        A = a[0]["found"].shape[0]
        for n in (1, 7, 15, 17, 33, A - 1, A):
            cpu = sliced(a, n)
            dev = tuple({f: v.to(card) for f, v in x.items()} if isinstance(x, dict)
                        else x.to(card) if torch.is_tensor(x) else x for x in cpu)
            swin = swin_over_shards(cpu[0], cpu[2], idx.k)
            for kw in ({}, {"swin": swin}):
                want = ST.stream_chain_plain(*cpu, **kw)
                d = dict(kw, swin=swin.to(card)) if kw else {}
                got = ST.stream_chain(*dev, **d)
                for key in want:
                    assert torch.equal(got[key].cpu(), want[key]), (name, n, key, kw.keys())
