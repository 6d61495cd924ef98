"""sshash_tpu_torch.bounds on the CPU: the bytes probe_bytes counts for a
batch are its lanes' own bytes plus the distinct table rows they read, in
both row formats, and lookup_bounds takes the larger of the bytes and the
minimizer's operations. Integer counts, compared exactly."""

import numpy as np
import pytest
import torch

from sshash_tpu_torch import TorchEngine, oracle, synthetic
from sshash_tpu_torch import bounds as B
from sshash_tpu_torch import engine as E
from sshash_tpu_torch import layout as L
from sshash_tpu_torch.ops import packed as P
from sshash_tpu_torch.ops import u64 as u
from one_thread import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", ["m13_regular", "m13_canonical"])
def test_probe_bytes_counts_lanes_and_distinct_rows(name):
    """Without skew classes: per lane its kmer in and 10 bytes of id
    fields out (kernel 2 also reads its reverse complement and minimizer
    tries), a pilot word a lane capped at the pilots table, and each
    distinct fused row once; v2 rows are narrower, so v2 counts fewer
    bytes for the same lanes."""
    idx = synthetic.small_index(name)
    rng = np.random.default_rng(7)
    km = oracle.access(idx, rng.integers(0, idx.num_kmers, 999))
    got = {}
    for rf in ("v1", "v2"):
        eng = TorchEngine(idx, "cpu", row_format=rf)
        cfg, t = eng.cfg, eng.tables
        assert not cfg.has_skew
        kt = eng.kmers32(km)
        args = B.probe_args(cfg, kt, P.minimizer)
        slot = E.mphf_eval_minimizer(cfg, t, u.from_i64(args[1]))
        rows = int(torch.unique(slot.clamp(max=t["cw_row"].shape[0] - 1)).numel())
        tables = min(4 * len(km), t["pilots"].numel() * 4) + rows * 4 * L.row_width(cfg)
        canon = 2 if cfg.canonical else 1
        fused = B.probe_bytes(cfg, t, kt, args, fused=True)
        assert fused == len(km) * (4 * cfg.W + 10) + tables
        assert B.probe_bytes(cfg, t, kt, args) == len(km) * (
            4 * cfg.W * canon + 8 + 4 * canon + 10) + tables
        b = B.lookup_bounds(cfg, len(km), B.probe_bytes(cfg, t, kt, args), fused)
        ops = len(km) * B.MINIMIZER_OPS_PER_WINDOW * (cfg.k - cfg.m + 1)
        assert b["lookup"] == max(B.bound(fused), B.bound(0, ops))
        assert b["lookup_bytes"] == B.bound(fused) == (fused / B.HBM_BPS * 1e3, "bytes")
        got[rf] = fused
    assert got["v2"] < got["v1"]
