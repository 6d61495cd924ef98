"""The lookup kernel's plain version, engine.lookup_plain (and the CPU
dispatch of TorchEngine.lookup, which runs it), against the JAX package's
DeviceEngine (JAX on the CPU) and both oracles, in every lane and every
field; on a card, kernels.lookup_kernel against lookup_plain and the
two-kernel form (kernel 1, the fold or the RC retry, kernel 2).

Cases: every small configuration (k15..k63, regular and canonical, heavy
and mid buckets, candidate 1 in the row, a partitioned MPHF) and both k65
ones in v1 rows; v2 rows on four of them; both legacy skew forms of the
m3_skew indexes. Each batch is query_batch's odd-sized mix (B not a
multiple of 16) plus, on a canonical index, tie_batch's tie lanes that hit
and that miss. The kernels are integer-only: the tolerance is exact
equality.

The card tests import no JAX (the CPU ones import the JAX engine inside
the test), so a machine with a card and no JAX runs them:

    python -m pytest --noconftest -m cuda tests/test_torch_lookup_kernel.py
"""

import functools

import numpy as np
import pytest
import torch

from sshash_tpu import oracle as joracle
from sshash_tpu_torch import TorchEngine, kernels, oracle, synthetic
from sshash_tpu_torch import engine as E
from sshash_tpu_torch.constants import BACKWARD_ORIENTATION, FORWARD_ORIENTATION
from sshash_tpu_torch.ops import packed as P
from test_torch_host import jax_index
from one_thread import one_torch_thread  # noqa: F401

INVALID = np.uint64(2 ** 64 - 1)
TIES = 60  # tie lanes that hit, and as many that miss, per canonical configuration
V2_CONFIGS = ("m13_regular", "m3_skew_canonical", "partitioned", "k63")
LEGACY = [(name, plain) for name in ("m3_skew", "m3_skew_canonical") for plain in (False, True)]
CASES = ([(name, "v1") for name in sorted(synthetic.SMALL_CONFIGS)]
         + [("k65", "v1"), ("k65_canonical", "v1")]
         + [(name, "v2") for name in V2_CONFIGS]
         + [(name, "legacy_plain_mphf" if plain else "legacy") for name, plain in LEGACY])


@functools.lru_cache(maxsize=None)
def index(name, form):
    """The configuration's index, in the legacy skew forms for those."""
    idx = synthetic.small_index(name)
    if form.startswith("legacy"):
        idx = synthetic.legacy_skew(idx, plain_mphf=form == "legacy_plain_mphf")
    return idx


@functools.lru_cache(maxsize=None)
def batch(name):
    """(query batch, tie hits' lanes, tie misses' lanes), from the v1.2
    index."""
    idx = synthetic.small_index(name)
    q, _ = synthetic.query_batch(idx)
    hits = misses = np.zeros(0, dtype=np.int64)
    if idx.canonical:
        th, tm = synthetic.tie_batch(idx, np.random.default_rng(7), TIES)
        hits = len(q) + np.arange(len(th))
        misses = len(q) + len(th) + np.arange(len(tm))
        q = np.concatenate([q, th, tm])
    if len(q) % 16 == 0:
        q = q[:-1]
    return q, hits, misses


def engine(name, form, device):
    return TorchEngine(index(name, form), device, row_format="v2" if form == "v2" else None)


def host(res):
    return E._to_host_result(res)


def active_mask(B, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).random(B) < 0.8)


def assert_inactive(res, active, fields):
    """Lanes outside active report what an inactive lane of the two-kernel
    form reports: not found, FORWARD, minimizer_found set, every u32 field
    0xFFFFFFFF."""
    off = ~active
    assert not res["found"][off].any()
    assert bool(res["minimizer_found"][off].all())
    assert bool((res["kmer_orientation"][off] == FORWARD_ORIENTATION).all())
    for key in ("kmer_id",) + (("kmer_id_in_string", "kmer_offset", "string_id",
                                "string_begin", "string_end") if fields == "full" else ()):
        assert bool((res[key][off] == -1).all()), key


@pytest.mark.parametrize("name,form", CASES, ids=[f"{n}-{f}" for n, f in CASES])
def test_lookup_plain_equals_jax_and_oracles(name, form, monkeypatch):
    from sshash_tpu.engine import DeviceEngine

    idx = index(name, form)
    q, hits, misses = batch(name)
    jidx = jax_index(idx)
    if form == "v2":
        monkeypatch.setenv("SSHASH_ROW_V2", "1")
    jeng = DeviceEngine(jidx)
    assert jeng.cfg.row_v2 == (form == "v2")
    want = jeng.lookup(q)
    eng = engine(name, form, "cpu")
    cfg = eng.cfg
    kt = eng.kmers32(q)
    fields = "ids" if cfg.row_v2 else "full"
    before = kernels.counts()
    got = host(E.lookup_plain(cfg, eng.tables, kt, None, fields))
    assert kernels.counts() == before
    for ref in (oracle.lookup(idx, q), joracle.lookup(jidx, q)):
        for key in got:
            assert np.array_equal(want[key], ref[key]), f"{key}: jax vs an oracle"
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), f"{key} vs jax"
    # the CPU dispatch of the engine's lookup and lookup_ids runs lookup_plain
    eng_got = eng.lookup(q)
    ids = host(eng.lookup_ids_device(kt))
    for key in want:
        assert np.array_equal(eng_got[key], want[key]), f"engine {key}"
    assert set(ids) == {"kmer_id", "kmer_orientation", "minimizer_found"}
    for key in ids:
        assert np.array_equal(ids[key], want[key]), f"ids {key}"
    assert kernels.counts() == before
    found = got["kmer_id"] != INVALID
    assert len(q) % 16 and found.any() and (~found).any()
    if not cfg.canonical:
        # a lane that missed on both strands reports BACKWARD
        assert (got["kmer_orientation"][~found] == BACKWARD_ORIENTATION).all()
    if name == "k65_canonical":
        assert len(hits) and len(misses)
    assert found[hits].all() and not found[misses].any()
    # an active mask: the active lanes as before, the others inactive
    active = active_mask(len(q))
    res = E.lookup_plain(cfg, eng.tables, kt, active, fields)
    assert_inactive(res, active, fields)
    sub = host({key: v[active] for key, v in res.items()})
    for key in want:
        assert np.array_equal(sub[key], want[key][active.numpy()]), f"active {key}"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the lookup kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,form", CASES + [("k127_canonical", "v1"), ("k129_canonical", "v1")],
                         ids=[f"{n}-{f}" for n, f in CASES] + ["k127_canonical-v1",
                                                                "k129_canonical-v1"])
def test_lookup_kernel_equals_plain_and_two_kernels_on_card(card, name, form):
    eng = engine(name, form, card)
    cfg = eng.cfg
    q, _, _ = batch(name)
    kt = eng.kmers32(q)
    active = active_mask(len(q)).to(card)
    for fields in ("ids",) if cfg.row_v2 else ("full", "ids"):
        two = E.make_lookup(cfg, fields, minimizer=P.minimizer, probe=E.probe)
        for act in (None, active):
            got = kernels.lookup_kernel(cfg, eng.tables, kt, act, fields)
            for want in (E.lookup_plain(cfg, eng.tables, kt, act, fields),
                         two(eng.tables, kt, active=act)):
                assert got.keys() == want.keys()
                for key in want:
                    assert torch.equal(got[key], want[key]), (fields, act is None, key)
    want = oracle.lookup(index(name, form), q)
    got = eng.lookup(q)
    for key in got:
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["m13_regular", "m3_skew_canonical", "k65_canonical"])
def test_engine_paths_launch_the_lookup_kernel_once_on_card(card, name):
    """The engine's lookup, lookup_ids and navigation are one launch of the
    lookup kernel each (navigation after the variants kernel), and neither
    kernel 1 nor kernel 2 launches."""
    eng = engine(name, "v1", card)
    q, _, _ = batch(name)
    kt = eng.kmers32(q)
    for call, extra in ((eng.lookup_device, {}), (eng.lookup_ids_device, {}),
                        (eng.kmer_neighbours_device, {"neighbours_kernel": 1})):
        kernels.reset_counts()
        call(kt)
        torch.cuda.synchronize()
        got = {key: v for key, v in kernels.counts().items() if v}
        assert got == {"lookup_kernel": 1, **extra}, got


def test_lookup_kernel_takes_cuda_tensors_only():
    eng = engine("m9_c1", "v1", "cpu")
    kt = torch.zeros((4, eng.cfg.W), dtype=torch.int32)
    before = kernels.counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.lookup_kernel(eng.cfg, eng.tables, kt)
    with pytest.raises(ValueError, match="no lookup kernel for device meta"):
        E.lookup(eng.cfg, eng.tables, torch.empty((4, eng.cfg.W), device="meta"))
    assert kernels.counts() == before
