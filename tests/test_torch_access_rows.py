"""Access over rows of every width residue (synthetic.ACCESS_CONFIGS) on
the CPU: the port's access, unsharded and on (1, 4) and (2, 2) bucket
shards (both rounds of the two-round form), against the JAX package's
DeviceEngine and the NumPy oracle. The ids take every position of every
32-id block, the last partial block included. The card's access kernel
stages these rows by aligned 16-byte segments, so a row's word within its
segment and the segments it spans are what these indexes vary;
tests/test_torch_kernels.py holds the kernel to its plain version on
them. All outputs are integers: the tolerance is 0."""

import numpy as np
import pytest
import torch

from sshash_tpu import oracle
from sshash_tpu.engine import DeviceEngine
from sshash_tpu_torch import TorchEngine, kernels, synthetic
from sshash_tpu_torch import engine as E
from sshash_tpu_torch.layout import AccessShard, acc_width, acc_windowed
from sshash_tpu_torch.ops.u64 import to_i32, u32
from sshash_tpu_torch.parallel import LocalMesh, ShardedEngine
from test_torch_host import jax_index
from one_thread import one_torch_thread  # noqa: F401

NAMES = sorted(synthetic.ACCESS_CONFIGS)


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    idx = synthetic.small_index(request.param)
    return request.param, idx, DeviceEngine(jax_index(idx))


def all_ids(idx):
    """Every id of the index; its last 32-id block is partial."""
    n = idx.num_kmers
    assert n % 32, "the last 32-id block must be partial"
    return np.arange(n, dtype=np.uint32)


def uneven_cuts(n, parts):
    """parts ranges over [0, n), cut at 1/7, 1/2 and 3/4 of it."""
    return [0] + [int(n * f) + 1 for f in (1 / 7, 1 / 2, 3 / 4)[:parts - 1]] + [n]


def test_access_configs_cover_every_row_residue():
    """Windowed rows of widths 0, 1, 2 and 3 mod 4 with C >= 2 (the widest,
    16 words, among them), a two-round index with C >= 2 and a windowed
    W = 5 index."""
    forms = {}
    for name in NAMES:
        cfg = TorchEngine(synthetic.small_index(name), "cpu").cfg
        forms[name] = (acc_windowed(cfg.k, cfg.access_C), acc_width(cfg), cfg.access_C, cfg.W)
    windowed = [(w, C) for win, w, C, _ in forms.values() if win and C >= 2]
    assert {w % 4 for w, _ in windowed} == {0, 1, 2, 3}
    assert max(w for w, _ in windowed) == 16
    assert any(not win and C >= 2 for win, _, C, _ in forms.values())
    assert any(win and W == 5 for win, _, _, W in forms.values())


def test_access_rows_equal_jax_and_oracle(case):
    name, idx, jeng = case
    eng = TorchEngine(idx, "cpu")
    ids = all_ids(idx)
    got = eng.access(ids)
    assert np.array_equal(got, oracle.access(jax_index(idx), ids)), name
    assert np.array_equal(got, jeng.access(ids)), name
    beyond = np.array([idx.num_kmers, idx.num_kmers + 31, 2 ** 31, 2 ** 32 - 1], dtype=np.uint32)
    if acc_windowed(idx.k, eng.cfg.access_C):
        assert np.array_equal(eng.access(beyond), jeng.access(beyond)), name


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_sharded_access_rows_equal_jax_and_oracle(case, shape):
    """The bucket-sharded engine (the windowed form's one round, or the
    two-round form's char offsets then the word owners' reads), and each
    shard's rounds on uneven cuts of the id blocks and string words, whose
    tables are slices that start at any word of a segment."""
    name, idx, jeng = case
    ids = all_ids(idx)
    seng = ShardedEngine(idx, LocalMesh(shape, "cpu"))
    got = seng.access(ids)
    assert np.array_equal(got, jeng.access(ids)), name
    assert np.array_equal(got, oracle.access(idx, ids)), name
    eng = TorchEngine(idx, "cpu")
    cfg, t = eng.cfg, eng.tables
    it = torch.from_numpy(ids.view(np.int32))
    bc, wc = (uneven_cuts(t[key].shape[0], shape[1]) for key in ("acc_rows", "strings32"))
    shards = [AccessShard(a, b, c, d) for a, b, c, d in zip(bc, bc[1:], wc, wc[1:])]
    tabs = [dict(t, acc_rows=t["acc_rows"][s.blk_lo:s.blk_hi],
                 strings32=t["strings32"][s.word_lo:s.word_hi + cfg.W + 1]) for s in shards]
    firsts = [E.access(cfg, tab, it, sh) for sh, tab in zip(shards, tabs)]
    if firsts[0].dim() == 1:
        off = to_i32(torch.stack([u32(f) for f in firsts]).amin(0))
        assert not (off == -1).any()  # every id's block has its owner
        firsts = [E.access_read(cfg, tab, off, sh) for sh, tab in zip(shards, tabs)]
    parts = torch.stack([u32(f) for f in firsts])
    assert int((parts != 0).sum(0).max()) <= 1  # one owner a lane and word
    assert torch.equal(to_i32(parts.amax(0)), E.access(cfg, t, it)), name


def test_staged_tables_need_an_aligned_storage():
    """The access kernel loads the aligned 16-byte segments around a row,
    which lie in the table's allocation when its storage starts aligned: a
    slice of an allocation passes, a storage that starts 4 bytes into one
    is refused."""
    base = torch.zeros(64, dtype=torch.int32)
    assert base.untyped_storage().data_ptr() % 16 == 0
    kernels._check_staged(base[1:], "acc_rows")
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels._check_staged(torch.from_numpy(base.numpy()[1:]), "acc_rows")
