"""Global constants for the TPU-native SSHash engine.

Semantics mirror the reference constants (reference: include/constants.hpp:5-26),
but values that only tuned the C++ memory subsystem (RAM caps, tmp dirs) are
host-build concerns here.
"""

INVALID_UINT64 = (1 << 64) - 1
INVALID_UINT32 = (1 << 32) - 1

SEED = 1  # default build seed (reference: constants.hpp:7)

# Skew-index thresholds (reference: constants.hpp:13-16): buckets with more than
# 2**MIN_L distinct minimizer positions go to the skew index; at most
# MAX_L - MIN_L + 1 = 8 partitions so a partition id fits in 3 bits.
# The reference sweeps these by editing constants.hpp and RECOMPILING
# (script/sweep-min-l.py:34-70); the process-level analog here is an env
# override read once at import (see scripts/sweep_min_l.py). MIN_L is part
# of the codeword bit format, so indexes record it and loading checks it.
import os as _os

MIN_L = int(_os.environ.get("SSHASH_MIN_L", "6"))
MAX_L = int(_os.environ.get("SSHASH_MAX_L", str(MIN_L + 7)))
if not (1 <= MIN_L <= MAX_L) or MAX_L - MIN_L + 1 > 8:
    raise ValueError(f"need MIN_L <= MAX_L <= MIN_L+7 (3-bit partition ids), "
                     f"got {MIN_L}..{MAX_L}")

# PTHash-analog MPHF tuning (reference: constants.hpp:10-11). LAMBDA is the
# average bucket size of the pilot search; ALPHA the table load factor.
# Key sets above AVG_PARTITION_SIZE build hash-range-partitioned MPHFs
# (mphf.PartitionedMPHF; reference avg_partition_size, constants.hpp:11).
LAMBDA = 5.0
ALPHA = 0.94
AVG_PARTITION_SIZE = 3_000_000
SKEW_LAMBDA_BOOST = 2.0  # skew-index kmer MPHFs use lambda + 2 (reference: build_sparse_and_skew_index.cpp:319-320)

FORWARD_ORIENTATION = 1
BACKWARD_ORIENTATION = -1

# Index (de)serialization version. Major mismatch => rebuild required
# (reference: util.hpp:191-195).
VERSION = (1, 3, 0)

# Bucket status codes stored in the low bits of a control codeword
# (reference: util.hpp:13-17 and build_sparse_and_skew_index.cpp:119,209,226).
SINGLETON = 0
MIDLOAD = 1
HEAVYLOAD = 3
