"""Rebased (v2) rows in the port's layout, whose candidate blocks carry the
resolve words (kid0, rel_ep1) without the JAX package's sid0, against the
JAX package (its DeviceEngine built with SSHASH_ROW_V2=1, set with
monkeypatch, and the v2 tables it serves) and both oracles (the JAX
package's and the port's), on the CPU, on seeds drawn with numpy
(synthetic.query_batch: an odd batch of positives, half
reverse-complemented, path kmers and random kmers). All outputs are
integers: the tolerance is 0.

The JAX engine's jitted lookup takes 5-135 s to compile a configuration
here, so these tests hold the port to the JAX v2 engine's tables (through
layout.port_tables) and to the JAX oracle, not to its lookup;
tests/test_torch_capacity.py holds the port's v2 lookup to the JAX v2
engine's on every small configuration."""

import json

import numpy as np
import pytest

from sshash_tpu import oracle as joracle
from sshash_tpu.engine import DeviceEngine, _device_arrays
from sshash_tpu_torch import TorchEngine, oracle, synthetic
from sshash_tpu_torch import layout as L
from sshash_tpu_torch.engine import _to_host_result
from sshash_tpu_torch.parallel import LocalMesh, ShardedEngine
from test_torch_host import jax_index
from one_thread import one_torch_thread  # noqa: F401

IDS_KEYS = ("kmer_id", "kmer_orientation", "minimizer_found")
INVALID = np.uint64(2 ** 64 - 1)
BASE = (1 << 31) + 12345
M32 = 0xFFFFFFFF
# every small configuration (a partitioned MPHF in "partitioned", candidate
# 1 in the row in "m9_c1"), k65 and k129, and both legacy skew forms
CASES = sorted(synthetic.SMALL_CONFIGS) + ["k65", "k129_canonical", "legacy_no_hindex",
                                            "legacy_plain_mphf"]


def _index(case):
    if case.startswith("legacy"):
        return synthetic.legacy_skew(synthetic.small_index("m3_skew_canonical"),
                                     plain_mphf=case == "legacy_plain_mphf")
    return synthetic.small_index(case)


@pytest.fixture(scope="module", params=CASES)
def v2(request):
    """(case, index, its query batch, the JAX index, the JAX v2 engine's
    table dict, the port's v2 engine)."""
    case = request.param
    idx = _index(case)
    q, _ = synthetic.query_batch(idx)
    assert len(q) % 16
    jidx = jax_index(idx)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SSHASH_ROW_V2", "1")
        jeng = DeviceEngine(jidx)
        jarrs = _device_arrays(jidx)
    assert jeng.cfg.row_v2 and jeng.cfg.quad_w == 3
    for key in ("cw_row", "mid_rows"):  # the tables the JAX engine serves
        assert np.array_equal(np.asarray(jeng.arrs[key]), jarrs[key]), key
    return case, idx, q, jidx, jarrs, TorchEngine(idx, "cpu", row_format="v2")


def test_v2_lookup_equals_jax_and_oracles(v2):
    """lookup and is_member of the port's v2 engine, and of one over the
    JAX v2 engine's tables, equal both oracles in the id fields."""
    case, idx, q, jidx, jarrs, eng = v2
    assert eng.cfg.row_v2 and eng.cfg.quad_w == 2
    want, jwant = oracle.lookup(idx, q), joracle.lookup(jidx, q)
    from_jax = TorchEngine(idx, "cpu", host_arrs=jarrs, row_format="v2")
    got, got_j = eng.lookup(q), from_jax.lookup(q)
    assert set(got) == set(got_j) == set(IDS_KEYS)
    for key in IDS_KEYS:
        assert np.array_equal(got[key], want[key]), f"{case}: {key} vs the port's oracle"
        assert np.array_equal(got[key], jwant[key]), f"{case}: {key} vs the JAX oracle"
        assert np.array_equal(got_j[key], got[key]), f"{case}: {key} over JAX's tables"
    member = want["kmer_id"] != INVALID
    assert member.any() and not member.all()
    assert np.array_equal(eng.is_member(q), member)
    assert np.array_equal(from_jax.is_member(q), member)


def test_v2_rebased_ids_above_2_31(v2):
    """rebase_ids on the new layout (kid0 still the first resolve word):
    every found id comes back as the oracle's + 2^31 + 12345 mod 2^32, at
    or above 2^31, every miss as 0xFFFFFFFF."""
    case, idx, q, _, _, eng = v2
    want = oracle.lookup(idx, q)["kmer_id"]
    hi = synthetic.rebase_ids(eng.cfg, eng.tables, BASE)
    res = _to_host_result(eng._lookup_ids(hi, eng.kmers32(q)))
    found = want != INVALID
    expect = np.where(found, (want + np.uint64(BASE)) & np.uint64(M32), INVALID)
    assert np.array_equal(res["kmer_id"], expect), case
    assert (res["kmer_id"][found] >= np.uint64(1 << 31)).all()


def test_v2_tables_from_jax_dict_equal_device_arrays(v2):
    """tables_from_host of the JAX v2 dict equals device_arrays(idx, "v2")
    key by key (a legacy dict's heavy path converted through the index);
    a v2 block is 2 words narrower than v1's (the quad's 4 against kid0,
    rel_ep1), and the row adds only row_pad's zeros."""
    case, idx, _, _, jarrs, _ = v2
    cfg, cfg1 = L.StaticCfg(idx, "v2"), L.StaticCfg(idx, "v1")
    nblk = 2 if cfg.c1_in_row else 1
    assert L.cand_block_width(cfg) == L.cand_block_width(cfg1) - 2
    assert L.row_width(cfg) - L.row_pad(cfg) == L.row_width(cfg1) - 2 * nblk
    assert jarrs["cw_row"].shape[1] == L.row_width(cfg1) - nblk
    own = L.device_arrays(idx, "v2")
    assert own["cw_row"].shape[1] == L.row_width(cfg)
    pad = own["cw_row"][:, L.row_width(cfg) - L.row_pad(cfg):]
    assert not pad.any()
    got, want = L.tables_from_host(jarrs, "cpu", cfg, idx), L.tables_from_host(own, "cpu", cfg)
    assert set(got) == set(want)
    for key in want:
        assert np.array_equal(got[key].numpy(), want[key].numpy()), f"{case}: {key}"


@pytest.mark.parametrize("case", ["m3_skew", "m9_c1", "k63", "legacy_no_hindex"])
@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_v2_sharded_equals_unsharded(case, shape):
    """A LocalMesh ShardedEngine in v2 rows, from its own tables and from
    the JAX package's v2 dict, equals the unsharded v2 engine (a hand-off
    index, candidate 1 in the row, a padded row, the legacy skew form)."""
    idx = _index(case)
    q, _ = synthetic.query_batch(idx)
    want = TorchEngine(idx, "cpu", row_format="v2").lookup(q)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SSHASH_ROW_V2", "1")
        jarrs = _device_arrays(jax_index(idx))
    for host in (None, jarrs):
        seng = ShardedEngine(idx, LocalMesh(shape, "cpu"), host_arrs=host, row_format="v2")
        got, report = seng.lookup(q)
        assert set(got) == set(IDS_KEYS) and report["num_kmers"] == len(q)
        for key in IDS_KEYS:
            assert np.array_equal(got[key], want[key]), f"{case} {shape}: {key}"


def test_row_pad_where_it_stages_fewer_loads():
    """v2 rows are padded to a multiple of 4 words where that stages the
    row head in fewer 16-byte loads or touches fewer sectors: not at k31
    m21 (10 words: 3 loads, 2 sectors wherever a row starts), at k63 and
    k65 m25 without candidate 1 (15 words to 16: 4.5 loads to 4, 2.75
    sectors to 2); never in v1."""
    g = L.row_geometry(31, 21, True, False)
    assert L.row_width(g) == 10 and L.row_pad(g) == 0
    assert L.head_loads(10, 10) == 3 and L.head_sectors(10, 10) == 2
    for k in (63, 65):
        g = L.row_geometry(k, 25, True, False)
        assert L.row_pad(g) == 1 and L.row_width(g) == 16
        assert L.head_loads(15, 15) == 4.5 and L.head_loads(15, 16) == 4
        assert L.head_sectors(15, 15) == 2.75 and L.head_sectors(15, 16) == 2
        assert L.row_pad(L.row_geometry(k, 25, True, True)) == 0  # 28 words
    for k in range(15, 256, 16):
        for c1 in (False, True):
            assert L.row_pad(L.row_geometry(k, min(31, k - 10), False, c1)) == 0


def test_earlier_v2_cache_refused(tmp_path):
    """A table cache whose layout record names other widths than its files
    hold (an 11-word v2 row at k31 m13 recorded as this layout's 10) is
    refused, naming its row width, and so is an 11-word cw_row over this
    layout's blocks. A cache without a record (an earlier tree's, whose v2
    blocks hold kid0, sid0, rel_ep1 as the JAX package's do, or a v1 cache,
    whose rows never changed) loads and serves through tables_from_host's
    conversion, never read in the earlier layout; write_tables' cache of
    this layout loads and serves."""
    idx = synthetic.small_index("m13_regular")
    cfg = L.StaticCfg(idx, "v2")
    assert not cfg.c1_in_row and L.row_width(cfg) == 10
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SSHASH_ROW_V2", "1")
        jarrs = _device_arrays(jax_index(idx))
    assert jarrs["cw_row"].shape[1] == 11
    q, _ = synthetic.query_batch(idx)
    want = oracle.lookup(idx, q)

    def serves(arrs, row_format):
        got = TorchEngine(idx, "cpu", host_arrs=arrs, row_format=row_format).lookup(q)
        for key in IDS_KEYS:
            assert np.array_equal(got[key], want[key]), (row_format, key)

    old = tmp_path / "old"
    old.mkdir()
    for key, v in jarrs.items():
        np.save(old / f"{key}.npy", v)
    loaded = L.load_tables(str(old))
    assert loaded["cw_row"].shape[1] == 11
    serves(loaded, "v2")
    own = L.tables_from_host(L.device_arrays(idx, "v2"), "cpu", cfg)
    conv = L.tables_from_host(loaded, "cpu", cfg)
    assert all(np.array_equal(conv[key].numpy(), v.numpy()) for key, v in own.items())
    (old / L.LAYOUT_FILE).write_text(json.dumps(
        {"layout_version": 2, "row_format": "v2", "row_width": 10, "block_width": 8}))
    with pytest.raises(ValueError, match="cw_row 11 words a row and mid_rows 9, its layout "
                                         "record 10 and 8"):
        L.load_tables(str(old))
    arrs = L.write_tables(idx, str(tmp_path / "new"), "v2")
    assert json.loads((tmp_path / "new" / L.LAYOUT_FILE).read_text())["row_width"] == 10
    serves(arrs, "v2")
    v1 = tmp_path / "v1"
    v1.mkdir()
    for key, v in L.device_arrays(idx, "v1").items():
        np.save(v1 / f"{key}.npy", v)
    serves(L.load_tables(str(v1)), "v1")
    # a cw_row of neither layout is refused by the engine, naming both widths
    for bad in (dict(jarrs, cw_row=jarrs["cw_row"][:, :9]),
                dict(L.device_arrays(idx, "v2"), cw_row=jarrs["cw_row"])):
        with pytest.raises(ValueError, match=f"cw_row has {bad['cw_row'].shape[1]} words a row"):
            TorchEngine(idx, "cpu", host_arrs=bad, row_format="v2")
