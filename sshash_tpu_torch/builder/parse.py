"""Input parsing for the builder: FASTA / cf_seg, optionally gzipped, with
optional per-kmer weights in headers.

Mirrors reference semantics (src/builder/encode_strings.cpp:44-261):
  * FASTA build inputs are 2-line records: '>header' then one sequence line.
  * cf_seg lines are '<id>\t<sequence>'.
  * weighted headers: '>[id] LN:i:[len] ab:Z:[w0] [w1] ...' with len-k+1
    weights; weight RLE intervals run across sequence boundaries
    (encode_strings.cpp:119-132).
"""

import gzip
from dataclasses import dataclass, field

import numpy as np

from .. import kmer as K


@dataclass
class ParsedInput:
    codes: np.ndarray  # uint8 2-bit codes, all sequences concatenated
    endpoints: np.ndarray  # uint64[num_sequences + 1] char offsets, [0] = 0
    num_kmers: int
    max_len: int
    # weighted mode only: weight RLE intervals over the kmer-id space
    weight_interval_values: np.ndarray | None = None  # uint64[num_intervals]
    weight_interval_lengths: np.ndarray | None = None  # uint64[num_intervals+1] cumulative, [0]=0
    weight_counts: dict = field(default_factory=dict)  # weight value -> frequency


def _open(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _parse_weighted_header(line, k):
    """'>id LN:i:len ab:Z:w0 w1 ...' -> (seq_len, weights list)."""
    if not line.startswith(b">"):
        raise ValueError(f"expected '>' got {line[:1]!r}")
    parts = line.split(b" ")
    ln = next(p for p in parts if p.startswith(b"LN:i:"))
    seq_len = int(ln[5:])
    idx = line.index(b"ab:Z:") + 5
    weights = np.array(line[idx:].split(), dtype=np.uint64)
    if len(weights) != seq_len - k + 1:
        raise ValueError("weight sequence length mismatch")
    return seq_len, weights


class SequenceReader:
    """Streaming sequence iterator: yields per-sequence 2-bit codes while
    accumulating weight RLE intervals across sequence boundaries
    (encode_strings.cpp:119-132). Inspect the accumulator fields after
    exhausting the iterator."""

    def __init__(self, path, k, weighted=False, raw=False):
        self.path = path
        self.k = k
        self.weighted = weighted
        # raw=True yields sequence BYTES instead of 2-bit codes (no encode,
        # no validity check) — for consumers that encode only a subset
        # (distributed scan workers own 1/N of the blocks but must still
        # see every length to place them)
        self.raw = raw
        self.num_kmers = 0
        self.max_len = 0
        self.lengths = []
        self.wvals = []
        self.wlens = [0]
        self.wcounts = {}
        self._cur_val = None
        self._cur_len = 0
        self._consumed = False

    def __iter__(self):
        # the accumulators (lengths, num_kmers, weight RLE state) are
        # single-shot; a second pass would silently double-count
        if self._consumed:
            raise RuntimeError("SequenceReader is single-pass; create a new one")
        self._consumed = True
        k = self.k
        fmt_cf_seg = str(self.path).endswith((".cf_seg", ".cf_seg.gz"))
        with _open(self.path) as f:
            while True:
                header = f.readline()
                if not header:
                    break
                header = header.rstrip(b"\r\n")
                if fmt_cf_seg:
                    if not header:
                        continue
                    tab = header.index(b"\t")
                    seq = header[tab + 1 :]
                else:
                    if not header:
                        continue
                    if self.weighted:
                        seq_len, weights = _parse_weighted_header(header, k)
                        for w in weights:
                            wi = int(w)
                            self.wcounts[wi] = self.wcounts.get(wi, 0) + 1
                            if wi == self._cur_val:
                                self._cur_len += 1
                            else:
                                if self._cur_val is not None:
                                    self.wvals.append(self._cur_val)
                                    self.wlens.append(self.wlens[-1] + self._cur_len)
                                self._cur_val = wi
                                self._cur_len = 1
                    seq = f.readline().rstrip(b"\r\n")
                    if not seq:
                        break
                n = len(seq)
                if n < k:
                    raise ValueError(f"sequence shorter than k: {n} < {k}")
                if self.raw:
                    self.lengths.append(n)
                    self.num_kmers += n - k + 1
                    self.max_len = max(self.max_len, n)
                    yield seq
                    continue
                codes, ok = K.encode_chars(seq)
                if not ok.all():
                    bad = np.flatnonzero(~ok)[0]
                    raise ValueError(f"invalid character {chr(seq[bad])!r} in build input")
                self.lengths.append(n)
                self.num_kmers += n - k + 1
                self.max_len = max(self.max_len, n)
                yield codes
        if self.weighted and self._cur_val is not None:
            self.wvals.append(self._cur_val)
            self.wlens.append(self.wlens[-1] + self._cur_len)
            self._cur_val = None

    def finish(self, codes=None):
        """Build the ParsedInput from the accumulated state."""
        if not self.lengths:
            raise ValueError("empty input")
        endpoints = np.zeros(len(self.lengths) + 1, dtype=np.uint64)
        np.cumsum(self.lengths, out=endpoints[1:])
        return ParsedInput(
            codes=codes,
            endpoints=endpoints,
            num_kmers=self.num_kmers,
            max_len=self.max_len,
            weight_interval_values=np.array(self.wvals, dtype=np.uint64) if self.weighted else None,
            weight_interval_lengths=np.array(self.wlens, dtype=np.uint64) if self.weighted else None,
            weight_counts=self.wcounts if self.weighted else {},
        )


def parse_input(path, k, weighted=False):
    """Parse a build input file into concatenated 2-bit codes + boundaries."""
    reader = SequenceReader(path, k, weighted)
    chunks = list(reader)
    return reader.finish(codes=np.concatenate(chunks) if chunks else None)
