"""Index info and per-component space breakdown (reference src/info.cpp:5-61).

Bit accounting follows the reference's compressed formats so bits/kmer are
comparable with the published SPACE BREAKDOWN logs (BASELINE.md), even
though the in-memory device layout uses dense uint32 arrays.
"""

import json

import numpy as np


def space_breakdown(index):
    """Per-component bits, reference-format accounting."""
    stats = index.stats
    nbo = stats.get("num_bits_per_offset", 64)
    nbc = stats.get("num_bits_for_control", 64)
    parts = {}
    parts["minimizers_mphf"] = index.minimizer_mphf.num_bits()
    parts["control_codewords"] = len(index.codewords) * nbc
    parts["mid_load_buckets"] = len(index.mid_load_buckets) * nbo
    parts["begin_buckets_of_size"] = len(index.begin_buckets_of_size) * 32
    parts["strings"] = 2 * index.num_chars
    s = len(index.string_endpoints)
    avg = max(2, index.num_chars / max(1, s))
    parts["strings_offsets"] = s * (2 + max(1, int(np.ceil(np.log2(avg)))))
    skew = len(index.heavy_load_buckets) * nbo
    for p in index.skew_partitions:
        skew += p.mphf.num_bits() + len(p.positions) * 32
    parts["skew_index"] = skew
    if index.weights is not None:
        parts["weights"] = index.weights.num_bits()
    return parts


def actual_space_breakdown(index):
    """Per-component bits as ACTUALLY HELD in host RAM (dense arrays are
    dense; MPHF pilots/remap are compact for real — see compact.py). The
    reference-format column (space_breakdown) stays comparable with the
    published logs; this column is the real footprint."""
    parts = {}
    parts["minimizers_mphf"] = index.minimizer_mphf.num_bits()
    parts["control_codewords"] = 8 * index.codewords.nbytes
    parts["mid_load_buckets"] = 8 * index.mid_load_buckets.nbytes
    parts["begin_buckets_of_size"] = 8 * index.begin_buckets_of_size.nbytes
    parts["strings"] = 8 * index.strings64.nbytes
    parts["strings_offsets"] = 8 * index.string_endpoints.nbytes
    skew = 8 * index.heavy_load_buckets.nbytes
    for p in index.skew_partitions:
        skew += p.mphf.num_bits() + 8 * p.positions.nbytes
    parts["skew_index"] = skew
    if index.weights is not None:
        parts["weights"] = index.weights.num_bits()
    return parts


def print_space_breakdown(index, out=None):
    """Reference-format accounting AND actual host bytes, side by side:
    the compact widths alone would hide what the host really holds."""
    parts = space_breakdown(index)
    actual = actual_space_breakdown(index)
    total = sum(parts.values())
    total_a = sum(actual.values())
    n = max(1, index.num_kmers)
    lines = ["SPACE BREAKDOWN (bits/kmer: reference-format | actual host):"]
    for name, bits in sorted(parts.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {name}: {bits / n:.4f} | {actual.get(name, 0) / n:.4f}"
                     f" ({100.0 * bits / total:.2f}%)")
    lines.append(f"  total: {total / n:.4f} | {total_a / n:.4f} [bits/kmer]"
                 f" ({total / 8 / 1e6:.3f} | {total_a / 8 / 1e6:.3f} MB)")
    text = "\n".join(lines)
    print(text, file=out)
    return parts


def info_dict(index):
    return {
        "num_kmers": index.num_kmers,
        "num_strings": index.num_strings,
        "k": index.k,
        "m": index.m,
        "canonical": index.canonical,
        "weighted": index.weights is not None,
        "num_minimizers": index.num_minimizers,
        "bits_per_kmer": round(index.num_bits() / max(1, index.num_kmers), 4),
    }


def print_info(index, out=None):
    d = info_dict(index)
    for key, v in d.items():
        print(f"{key}: {v}", file=out)
    print_space_breakdown(index, out=out)
    print(json.dumps(d), file=out)
    return d
