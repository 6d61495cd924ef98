"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so a machine with a card and no JAX runs it
(tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Without a CUDA card the `cuda` tests skip (the kernels have no CPU mode);
the wrapper checks below run everywhere. Outputs are integers: tolerance 0.
"""

import numpy as np
import pytest
import torch

from sshash_tpu import oracle
from sshash_tpu_torch import TorchEngine, kernels, synthetic
from sshash_tpu_torch import engine as E
from sshash_tpu_torch.engine import canonical_fold, probe, probe_plain
from sshash_tpu_torch.ops import packed as P


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(synthetic.SMALL_CONFIGS))
def test_kernels_equal_plain_on_card(card, name):
    idx = synthetic.small_index(name)
    eng = TorchEngine(idx, card)
    q, _ = synthetic.query_batch(idx)
    kt = eng.kmers32(q)
    cfg = eng.cfg
    got = P.minimizer(kt, cfg.k, cfg.m, cfg.magic, both=True)
    want = P.minimizer_plain(kt, cfg.k, cfg.m, cfg.magic, both=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    mv, mp, rc, mv_r, mp_r = want
    args = (rc, *canonical_fold(mv, mp, mv_r, mp_r)) if cfg.canonical else (None, mv, mp, None)
    rng = np.random.default_rng(1)
    active = torch.from_numpy(rng.random(kt.shape[0]) < 0.9).to(card)
    for fields in ("full", "ids"):
        g = probe(cfg, eng.tables, kt, *args, active, fields)
        w = probe_plain(cfg, eng.tables, kt, *args, active, fields)
        assert g.keys() == w.keys()
        for key in w:
            assert torch.equal(g[key], w[key]), key
    host, want = eng.lookup(q), oracle.lookup(idx, q)
    for key in want:
        assert np.array_equal(host[key], want[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(synthetic.SMALL_CONFIGS))
def test_point_query_kernels_equal_plain_on_card(card, name):
    """Access (both forms), iteration, weight and the neighbour variants."""
    idx = synthetic.small_index(name)
    eng = TorchEngine(idx, card)
    cfg, t = eng.cfg, eng.tables
    rng = np.random.default_rng(2)
    ids = np.concatenate([np.arange(idx.num_kmers), rng.integers(0, 1 << 32, 999)])
    it = torch.from_numpy(ids.astype(np.uint32).view(np.int32)).to(card)
    before = kernels.counts()
    got = E.access(cfg, t, it)
    assert torch.equal(got, E.access_plain(cfg, t, it))
    n = idx.num_kmers
    assert np.array_equal(eng.access(ids[:n]), oracle.access(idx, ids[:n]))
    got = E.iterate(cfg.k, t["strings32"], t["vstart32"])
    assert torch.equal(got, E.iterate_plain(cfg.k, t["strings32"], t["vstart32"]))
    assert eng.iterator()[0] == idx.num_kmers
    if cfg.weighted:
        assert torch.equal(E.weight(t, it), E.weight_plain(t, it))
        assert np.array_equal(eng.weight(ids[:n]), idx.weights.weight(ids[:n]))
    kt = eng.kmers32(oracle.access(idx, ids[:4096] % n))
    assert torch.equal(P.neighbour_variants(kt, cfg.k), P.neighbour_variants_plain(kt, cfg.k))
    after = kernels.counts()
    for kern in ("access_kernel", "iterate_kernel", "neighbours_kernel") + (
            ("weight_kernel",) if cfg.weighted else ()):
        assert after[kern] > before[kern], kern


def test_wrappers_take_cuda_tensors_only():
    idx = synthetic.small_index("m9_c1")
    eng = TorchEngine(idx, "cpu")
    cfg = eng.cfg
    kt = torch.zeros((4, cfg.W), dtype=torch.int32)
    before = kernels.counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.minimizer_kernel(kt, cfg.k, cfg.m, cfg.magic)
    mv = torch.zeros(4, dtype=torch.int64)
    mp = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.probe_kernel(cfg, eng.tables, kt, None, mv, mp)
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.access_kernel(cfg, eng.tables, ids)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.iterate_kernel(cfg.k, eng.tables["strings32"], eng.tables["vstart32"])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.weight_kernel(eng.tables, ids)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.neighbours_kernel(kt, cfg.k)
    assert kernels.counts() == before
    meta = torch.empty((4, cfg.W), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="minimizer"):
        P.minimizer(meta, cfg.k, cfg.m, cfg.magic)
    with pytest.raises(ValueError, match="probe"):
        probe(cfg, eng.tables, meta, None, mv, mp)


def test_library_name_tracks_sources():
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libsshash_tpu_torch_") and path.suffix == ".so"
    assert path == kernels.library_path()
