"""Build driver: input file -> Index.

Host-side pipeline mirroring the reference's 7 steps
(include/builder/dictionary_builder.hpp:17-79), with per-step timing emitted
as json-compatible stats. The external-memory sort/merge machinery of the
reference (builder/util.hpp:157-300) is replaced by in-memory vectorized
NumPy; out-of-core sharding by minimizer-hash range is the multi-host path
(builder/external.py, builder/distributed.py).
"""

import json
import time

import numpy as np
from dataclasses import dataclass



from .. import kmer as K
from ..constants import SEED
from ..hashing import mixer_magic
from .assemble import assemble
from .minimizers import compute_tuples
from .parse import parse_input


@dataclass
class BuildConfig:
    k: int = 31
    m: int = 20
    seed: int = SEED
    canonical: bool = False
    weighted: bool = False
    verbose: bool = True
    # worker threads for the builder hot loops (tuple scan chunks, the
    # parallel tuple sort, MPHF partition pilot searches) — the reference's
    # -t flag (tools/build.cpp:24). Results are bit-identical at any count.
    threads: int = 1
    # PTHash-style pilot-search lambda (avg bucket load) — the reference's
    # -a flag (tools/build.cpp:30); None = constants.LAMBDA
    lmbda: float = None
    # minimizer key sets beyond this build a partitioned MPHF (reference
    # avg_partition_size, constants.hpp:11); None = constants default
    avg_partition_size: int = None
    # out-of-core build (builder/external.py): tuples spill to hash-range
    # tmp files; assembly runs one MPHF partition at a time (the reference's
    # -d/-g flags, tools/build.cpp:34-44); a RAM budget selects it
    ram_limit_mb: int = None
    tmp_dir: str = None
    # multi-host analog: shard the minimizer-tuple scan over N worker
    # PROCESSES spilling to a shared directory, then assemble out-of-core
    # (builder/distributed.py; reference contrast: threads of one machine,
    # src/builder/compute_minimizer_tuples.cpp:19-117). scan_dir points the
    # assembly at a directory ALREADY spilled by scan_procs ranks of the
    # worker CLI (the real multi-host recipe; meta files are verified)
    scan_procs: int = 1
    scan_dir: str = None

    def validate(self):
        if self.k < 1 or self.m < 1 or self.m > self.k:
            raise ValueError(f"need 1 <= m <= k, got k={self.k} m={self.m}")
        if self.m > 31:
            raise ValueError("m must be <= 31 (minimizer values are uint64)")
        if self.k - self.m + 1 > 255:
            raise ValueError("k - m + 1 must fit in 8 bits")
        if self.threads < 1:
            raise ValueError("threads must be >= 1")
        if self.scan_procs < 1:
            raise ValueError("scan_procs must be >= 1")


def build(input_path, config: BuildConfig):
    config.validate()
    k, m = config.k, config.m
    stats = {"input_filename": str(input_path), "k": k, "m": m,
             "canonical": config.canonical, "seed": config.seed}
    t_total = time.perf_counter()

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        stats[name] = round(dt * 1e6)  # microseconds, like the reference json
        if config.verbose:
            print(f"=== {name}: {dt:.3f} [sec]")
        return out

    if (config.scan_procs > 1 or config.scan_dir is not None
            or config.ram_limit_mb is not None):
        if config.scan_procs > 1 or config.scan_dir is not None:
            from .distributed import build_distributed

            index = build_distributed(input_path, config, stats, timed,
                                      config.scan_procs)
        else:
            from .external import build_external

            index = build_external(input_path, config, stats, timed)
        stats["total_build_time_sec"] = time.perf_counter() - t_total
        stats["num_kmers"] = index.num_kmers
        stats.update(index.stats)
        index.stats = stats
        if config.verbose:
            print(json.dumps({kk: vv for kk, vv in stats.items()
                              if not kk.startswith("step")}))
        return index

    magic = mixer_magic(config.seed)

    from .. import native

    if native.available():
        # fused streaming parse -> pack -> scan: bounded RAM (never holds
        # whole-file byte codes; the reference's external-memory analog,
        # builder/util.hpp:157-300, with chunks instead of tmp files)
        parsed, words64, tuples = timed(
            "steps 1-3 (stream parse + pack + scan + sort)",
            lambda: _stream_parse_pack_scan(input_path, k, m, magic, config),
        )
    else:
        parsed = timed("step 1 (encode strings)",
                       lambda: parse_input(input_path, k, config.weighted))
        # sentinel pad so packed reads never go out of bounds (reference
        # encode_strings.cpp:183-188)
        words64 = timed("step 1b (pack 2-bit strings)",
                        lambda: K.pack_codes(parsed.codes, pad_words=K.num_words64(k) + 1))
        tuples = timed(
            "step 2+3 (compute + sort minimizer tuples)",
            lambda: compute_tuples(words64, parsed.endpoints, k, m, magic,
                                   config.canonical, codes=parsed.codes),
        )

    # small-m warning (reference encode_strings.cpp:201-214): with m below
    # ~log4(num_kmers)+1, buckets blow up and queries degrade sharply
    rec_m = int(np.ceil(np.log(max(2, parsed.num_kmers)) / np.log(4))) + 1
    if m < rec_m:
        print(f"WARNING: m = {m} is small for {parsed.num_kmers} kmers; "
              f"recommended m >= {rec_m} (query speed degrades with tiny m)")

    steps_seen = []
    index = timed(
        "steps 4-7 (mphf + sparse and skew index)",
        lambda: assemble(parsed, tuples, words64, k, m, config.seed, config.canonical,
                         verbose=config.verbose, on_step=steps_seen.append,
                         avg_partition_size=config.avg_partition_size,
                         threads=config.threads, lmbda=config.lmbda),
    )

    stats["total_build_time_sec"] = time.perf_counter() - t_total
    stats["num_kmers"] = index.num_kmers
    stats.update(index.stats)
    index.stats = stats
    if config.verbose:
        ns_per_kmer = stats["total_build_time_sec"] * 1e9 / max(1, index.num_kmers)
        print(f"=== total: {stats['total_build_time_sec']:.3f} [sec] "
              f"({ns_per_kmer:.1f} [ns/kmer])")
        print(json.dumps({kk: vv for kk, vv in stats.items() if not kk.startswith('step')}))
    return index


def _stream_parse_pack_scan(input_path, k, m, magic, config, chunk_chars=1 << 26):
    """Single pass over the input in ~chunk_chars blocks of whole sequences:
    pack 2-bit strings incrementally and run the native tuple scanner per
    block (sequence-relative, rebased to absolute afterwards). Peak RAM is
    packed strings + tuples, independent of input size.

    With config.threads > 1, chunk scans run on a thread pool (the ctypes
    scanner releases the GIL — the reference's thread-parallel minimizer
    scan, src/builder/compute_minimizer_tuples.cpp:19-117) and the final
    sort is the native chunked parallel sort (parallel_sort.hpp analog).
    Output is bit-identical at any thread count: chunks are keyed by their
    base offset and folded in order."""
    from .. import native
    from .minimizers import MinimizerTuples
    from .parse import SequenceReader

    threads = getattr(config, "threads", 1)
    pool = None
    if threads > 1:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=threads)

    reader = SequenceReader(input_path, k, config.weighted)
    words_parts = []
    carry = np.zeros(0, dtype=np.uint8)
    results = []  # (future-or-tuple, base) in submission order

    buf, buf_lens, buf_chars, base = [], [], 0, 0

    def flush():
        nonlocal carry, base, buf, buf_lens, buf_chars
        if not buf:
            return
        codes = np.concatenate(buf)
        ep = np.zeros(len(buf_lens) + 1, dtype=np.int64)
        np.cumsum(buf_lens, out=ep[1:])
        if pool is not None:
            # bounded in-flight window: each queued future pins its ~64MB
            # codes chunk, so an unbounded backlog would grow with input
            # size and break the peak-RAM contract below
            while sum(not r.done() for r, _ in results
                      if hasattr(r, "done")) >= 2 * threads:
                next(r for r, _ in results
                     if hasattr(r, "done") and not r.done()).result()
            results.append((pool.submit(native.tuple_scan, codes, ep, k, m,
                                        magic, config.canonical), base))
        else:
            results.append((native.tuple_scan(codes, ep, k, m, magic,
                                              config.canonical), base))
        # incremental 2-bit packing (32-char word alignment via carry)
        allc = np.concatenate([carry, codes]) if len(carry) else codes
        n32 = (len(allc) // 32) * 32
        if n32:
            words_parts.append(K.pack_codes(allc[:n32]))
        carry = allc[n32:]
        base += len(codes)
        buf, buf_lens, buf_chars = [], [], 0

    for codes in reader:
        buf.append(codes)
        buf_lens.append(len(codes))
        buf_chars += len(codes)
        if buf_chars >= chunk_chars:
            flush()
    flush()
    # tail + sentinel pad (reference encode_strings.cpp:183-188)
    words_parts.append(K.pack_codes(carry, pad_words=K.num_words64(k) + 1))
    words64 = np.concatenate(words_parts)

    t_min, t_pos, t_pik, t_cnt = [], [], [], []
    for res, b in results:
        mn, ps, pik, cnt = res.result() if pool is not None else res
        t_min.append(mn)
        t_pos.append(ps + np.uint64(b))
        t_pik.append(pik)
        t_cnt.append(cnt)
    if pool is not None:
        pool.shutdown()

    parsed = reader.finish(codes=None)
    minimizer = np.concatenate(t_min) if t_min else np.zeros(0, np.uint64)
    pos_in_seq = np.concatenate(t_pos) if t_pos else np.zeros(0, np.uint64)
    pos_in_kmer = np.concatenate(t_pik) if t_pik else np.zeros(0, np.uint8)
    count = np.concatenate(t_cnt) if t_cnt else np.zeros(0, np.uint8)
    from .. import native as _nat

    if threads > 1 and _nat.available():
        order = _nat.sort_tuples(minimizer, pos_in_seq, threads)
    else:
        order = np.lexsort((pos_in_seq, minimizer))
    tuples = MinimizerTuples(minimizer=minimizer[order], pos_in_seq=pos_in_seq[order],
                             pos_in_kmer=pos_in_kmer[order], count=count[order])
    return parsed, words64, tuples
