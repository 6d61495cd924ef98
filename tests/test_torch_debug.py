"""The port's sanitizer mode (sshash_tpu_torch/debug.py) against what
tests/test_debug.py requires of the JAX package's, on the small synthetic
configurations (that file's dict_k31 fixture reads the reference data):
the checked lookup passes a valid batch and equals the unchecked one and
the JAX package's checked lookup, a bound override raises with the JAX
message, debug_mode toggles and restores, assert_matches_oracle passes and
names a mismatching field, and SSHASH_DEBUG engages the check on
TorchEngine. On the CPU the check runs its plain version; the check kernel
is held to it on the card (tests/test_torch_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sshash_tpu import debug as jdebug
from sshash_tpu.engine import DeviceEngine
from sshash_tpu_torch import Dictionary, TorchEngine, debug, kernels, oracle, synthetic
from sshash_tpu_torch import kmer as K
from test_torch_host import jax_index
from one_thread import one_torch_thread  # noqa: F401

CONFIGS = ("m13_regular", "m3_skew_canonical", "k63", "k65_canonical")


def _batch(idx, rng, n=256):
    """n positives (half reverse-complemented), then n/4 random kmers."""
    ids = rng.integers(0, idx.num_kmers, n)
    km = oracle.access(idx, ids)
    km[::2] = K.revcomp_kmers(km[::2], idx.k)
    return ids, np.concatenate([km, synthetic.random_kmers(idx.k, rng, n // 4)])


@pytest.mark.parametrize("name", CONFIGS)
def test_checkified_lookup_passes_on_valid_batch(name):
    idx = synthetic.small_index(name)
    eng = TorchEngine(idx, "cpu")
    ids, km = _batch(idx, np.random.default_rng(1))
    kt = eng.kmers32(km)
    res = debug.checkified_lookup(eng)(kt)
    want = eng.lookup_device(kt)
    assert res.keys() == want.keys()
    for key in want:
        assert torch.equal(res[key], want[key]), key
    assert bool(res["found"][: len(ids)].all())
    assert np.array_equal(res["kmer_id"][: len(ids)].numpy().view(np.uint32),
                          ids.astype(np.uint32))


def test_checkified_lookup_equals_jax():
    """The same batch through the JAX package's checkified_lookup: both
    pass, with the same fields."""
    idx = synthetic.small_index("m13_canonical")
    eng = TorchEngine(idx, "cpu")
    _, km = _batch(idx, np.random.default_rng(2))
    kt = eng.kmers32(km)
    got = debug.checkified_lookup(eng)(kt)
    want = jdebug.checkified_lookup(DeviceEngine(jax_index(idx)))(
        jnp.asarray(kt.numpy().view(np.uint32)))
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        assert np.array_equal(got[key].numpy().view(w.dtype) if w.dtype == np.uint32
                              else got[key].numpy(), w), key


@pytest.mark.parametrize("name", CONFIGS)
def test_checkified_lookup_raises_on_violation(name):
    """A shrunk id (or char) range makes the real results violate the
    postcondition, which proves the check fires; the messages are the JAX
    package's."""
    idx = synthetic.small_index(name)
    eng = TorchEngine(idx, "cpu")
    kt = eng.kmers32(_batch(idx, np.random.default_rng(3))[1])
    with pytest.raises(debug.SanitizerError, match="kmer_id >= num_kmers") as e:
        debug.checkified_lookup(eng, num_kmers_bound=1)(kt)
    assert str(e.value) == debug.MESSAGES[0]
    assert isinstance(e.value, RuntimeError)
    with pytest.raises(debug.SanitizerError, match="kmer_offset >= num_chars"):
        debug.checkified_lookup(eng, num_chars_bound=1)(kt)


def test_check_flags_each_predicate():
    """Each postcondition on its own lane: the flag of that predicate only,
    and none from lanes that were not found."""
    found = torch.tensor([True, True, True, True, False])
    kid = torch.tensor([9, 1, 1, 1, -1], dtype=torch.int32)  # -1: 0xFFFFFFFF
    ori = torch.tensor([1, -1, 0, 1, 7], dtype=torch.int32)
    off = torch.tensor([5, 5, 5, 5, -1], dtype=torch.int32)
    beg = torch.tensor([0, 0, 0, 6, -1], dtype=torch.int32)
    flags = debug.check(found, kid, ori, off, beg, 9, 100).tolist()
    assert flags == [1, 0, 1, 1]
    assert debug.check(found, kid, ori, off, beg, 10, 5).tolist() == [0, 1, 1, 1]
    # rebased (v2) rows: no offset fields, the id and orientation only
    assert debug.check(found, kid, ori, None, None, 10, 0).tolist() == [0, 0, 1, 0]
    assert debug.check(found & (ori != 0), kid, ori, None, None, 10, 0).tolist() == [0] * 4


def test_v2_engine_checks_ids_and_orientation():
    """A v2 engine's lookup has no offset fields: the check tests kmer_id
    and orientation (the JAX version reads kmer_offset there and fails
    with a KeyError); its found ids equal the oracle's."""
    idx = synthetic.small_index("m3_skew")
    eng = TorchEngine(idx, "cpu", row_format="v2")
    ids, km = _batch(idx, np.random.default_rng(4))
    kt = eng.kmers32(km)
    res = debug.checkified_lookup(eng)(kt)
    assert "kmer_offset" not in res
    want = oracle.lookup(idx, km)["kmer_id"]
    got = res["kmer_id"].numpy().view(np.uint32).astype(np.uint64)
    got[~res["found"].numpy()] = np.uint64(2 ** 64 - 1)
    assert np.array_equal(got, want)
    debug.checkified_lookup(eng, num_chars_bound=1)(kt)  # no offsets to check
    with pytest.raises(debug.SanitizerError, match="kmer_id"):
        debug.checkified_lookup(eng, num_kmers_bound=1)(kt)


def test_debug_mode_toggles_and_restores():
    prev = kernels.sync_launches
    with debug.debug_mode():
        assert kernels.sync_launches is True
    assert kernels.sync_launches == prev
    with pytest.raises(KeyError):
        with debug.debug_mode():
            raise KeyError("inside")
    assert kernels.sync_launches == prev


def test_assert_matches_oracle(monkeypatch):
    idx = synthetic.small_index("k65_canonical")
    d = Dictionary(idx)
    _, km = _batch(idx, np.random.default_rng(5), 128)
    debug.assert_matches_oracle(d, km, device="cpu")
    eng = d.to_device("cpu")
    honest = eng.lookup

    def corrupted(q):
        res = honest(q)
        res["string_id"] = res["string_id"] ^ np.uint64(1)
        return res

    monkeypatch.setattr(eng, "lookup", corrupted)
    with pytest.raises(AssertionError, match="mismatch on string_id"):
        debug.assert_matches_oracle(d, km, device="cpu")


@pytest.mark.parametrize("value,engaged", [("1", True), ("0", False), ("", False)])
def test_sshash_debug_env_engages_sanitizer(monkeypatch, value, engaged):
    """SSHASH_DEBUG at construction routes lookup_device through the
    checked lookup, under synchronous launches; its answers are the
    unchecked lookup's."""
    idx = synthetic.small_index("m13_regular")
    ids, km = _batch(idx, np.random.default_rng(6), 64)
    monkeypatch.setenv("SSHASH_DEBUG", value)
    eng = TorchEngine(idx, "cpu")
    assert eng._debug is engaged
    seen = []
    check = debug.check

    def spy(*args):
        seen.append(kernels.sync_launches)
        return check(*args)

    monkeypatch.setattr(debug, "check", spy)
    kt = eng.kmers32(km)
    res = eng.lookup_device(kt)
    assert seen == ([True] if engaged else [])
    assert bool(res["found"][: len(ids)].all())
    assert np.array_equal(eng.lookup(km)["kmer_id"][: len(ids)], ids.astype(np.uint64))
    if engaged:
        eng._ck_lookup = debug.checkified_lookup(eng, num_kmers_bound=1)
        with pytest.raises(debug.SanitizerError, match="kmer_id"):
            eng.lookup(km)
