"""Partitioned MPHF soak: 100M distinct u64 keys (default_rng(99), unique,
the first n) through PartitionedMPHF.build_u64 in bounded time, then a
2M-key sample evaluated: every position in range and distinct. Host-only:
it never loads torch. Prints json lines.

Usage: python -m sshash_tpu_torch.tools.soak_mphf [--keys N]

--keys sets the key count (default 100,000,000) so that a test can run
the soak at a small size; below 2M keys the sample is every key, in a
random order.
"""

import argparse
import json
import time

import numpy as np

KEYS = 100_000_000
SAMPLE = 2_000_000


def soak(n=KEYS):
    """Build and evaluate; prints both json lines and returns (keys,
    sample, positions, the second line's fields)."""
    from ..mphf import PartitionedMPHF

    rng = np.random.default_rng(99)
    t0 = time.perf_counter()
    keys = rng.integers(0, 1 << 63, int(n * 1.01), dtype=np.uint64)
    keys = np.unique(keys)[:n]
    if len(keys) != n:
        raise RuntimeError(f"drew {len(keys)} distinct keys, want {n}")
    print(json.dumps({"gen_sec": round(time.perf_counter() - t0, 1)}), flush=True)

    t0 = time.perf_counter()
    f = PartitionedMPHF.build_u64(keys, seed=1)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sample = rng.choice(n, min(SAMPLE, n), replace=False)
    pos = f(keys[sample])
    eval_s = time.perf_counter() - t0
    ok_range = bool((pos >= 0).all() and (pos < n).all())
    distinct = len(np.unique(pos))
    row = {
        "n_keys": n, "partitions": f.num_partitions,
        "build_sec": round(build_s, 1),
        "ns_per_key": round(build_s * 1e9 / n, 1),
        "bits_per_key": round(f.num_bits() / n, 2),
        "eval_sec_2M": round(eval_s, 2),
        "sampled_positions_distinct": distinct == len(sample),
        "in_range": ok_range,
    }
    print(json.dumps(row), flush=True)
    if not (ok_range and distinct == len(sample)):
        raise RuntimeError(f"the sample's positions are out of range or repeat: {row}")
    return keys, sample, pos, row


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m sshash_tpu_torch.tools.soak_mphf")
    ap.add_argument("--keys", type=int, default=KEYS)
    args = ap.parse_args(argv)
    soak(args.keys)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
