"""The port's table layout against the JAX package's _device_arrays and
StaticCfg, tables_from_host on a JAX table dict (stale access rows
included), the formats the port refuses, and the port running with JAX
blocked from import."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from sshash_tpu import oracle
from sshash_tpu.engine import StaticCfg as JaxCfg
from sshash_tpu.engine import _device_arrays, vstart32_from_index
from sshash_tpu.engine import row_width as jax_row_width
from sshash_tpu_torch import TorchEngine, kernels, synthetic, to_device
from sshash_tpu_torch import engine as E
from sshash_tpu_torch import layout as L
from sshash_tpu_torch import streaming as ST
from sshash_tpu_torch.ops import packed as P
from sshash_tpu_torch.layout import (ACCESS_KEYS, LOOKUP_KEYS, OPTIONAL_KEYS, SKEW_PARAMS,
                                     WEIGHT_KEYS, StaticCfg, device_arrays, row_width,
                                     tables_from_host)
from test_torch_host import jax_index
from one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = ("k", "m", "canonical", "W", "kmw", "win_words", "vbits_words",
            "max_start_word", "quad_w", "magic", "c1_in_row", "mphf_partitioned",
            "mphf_table", "mphf_nbuckets", "mphf_seedmix", "pilot_w", "sk_pilot_w",
            "has_skew", "access_C", "row_v2", "num_chars", "skew_partitioned")


@pytest.fixture(scope="module", params=sorted(synthetic.SMALL_CONFIGS))
def built(request):
    idx = synthetic.small_index(request.param)
    return request.param, idx, _device_arrays(jax_index(idx))


def test_device_arrays_equal_jax(built):
    name, idx, jax_arrs = built
    port = device_arrays(idx)
    assert set(port) <= set(jax_arrs)
    assert set(LOOKUP_KEYS) <= set(port)
    assert {f"sk_{p}" for p in SKEW_PARAMS} <= set(port)
    assert {"acc_rows", "vstart32", "sidk32", "kmer_cum"} <= set(port)
    assert (set(WEIGHT_KEYS) <= set(port)) == (idx.weights is not None)
    assert np.array_equal(L.vstart32_from_index(idx), vstart32_from_index(jax_index(idx)))
    for key, v in port.items():
        assert v.dtype == np.uint32, key
        assert np.array_equal(v, jax_arrs[key]), key
    cfg, jcfg = StaticCfg(idx), JaxCfg(jax_index(idx))
    for attr in GEOMETRY:
        assert getattr(cfg, attr) == getattr(jcfg, attr), attr
    assert cfg.has_skew == jcfg.skew_hrows == cfg.skew_partitioned
    if cfg.mphf_partitioned:
        for attr in ("mphf_P", "mphf_part_table", "mphf_part_buckets"):
            assert getattr(cfg, attr) == getattr(jcfg, attr), attr
    assert row_width(cfg) == jax_row_width(jcfg) == port["cw_row"].shape[1]


def test_tables_from_jax_dict(built):
    """The JAX package's table dict feeds the port directly."""
    name, idx, jax_arrs = built
    cfg = StaticCfg(idx)
    from_jax = tables_from_host(jax_arrs, "cpu", cfg)
    own = tables_from_host(device_arrays(idx), "cpu", cfg)
    keys = set(LOOKUP_KEYS + OPTIONAL_KEYS + ACCESS_KEYS) | {"sk_params"}
    if idx.weights is not None:
        keys |= set(WEIGHT_KEYS)
    assert set(from_jax) == set(own) == keys
    for key in own:
        assert from_jax[key].dtype == own[key].dtype
        assert np.array_equal(from_jax[key].numpy(), own[key].numpy()), key
    assert from_jax["sk_params"].shape == (8, 8)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, idx.num_kmers, 257)
    km = oracle.access(idx, ids)
    got = TorchEngine(idx, "cpu", host_arrs=jax_arrs).lookup(km)
    assert np.array_equal(got["kmer_id"], ids.astype(np.uint64))


@pytest.mark.parametrize("name", ["m13_regular", "short_strings"])
def test_stale_access_tables_are_rebuilt(name):
    """A JAX table cache written before the access rows (or with rows of
    another width, or without vstart32) still serves access and iteration,
    with the tables device_arrays builds."""
    idx = synthetic.small_index(name)
    jax_arrs = _device_arrays(jax_index(idx))
    own = tables_from_host(device_arrays(idx), "cpu", StaticCfg(idx))
    ids = np.arange(idx.num_kmers)
    for drop, narrow in (("acc_rows", False), ("vstart32", False), (None, True)):
        stale = {key: v for key, v in jax_arrs.items() if key != drop}
        if narrow:
            stale["acc_rows"] = stale["acc_rows"][:, :2]
        eng = TorchEngine(idx, "cpu", host_arrs=stale)
        for key in ACCESS_KEYS:
            assert np.array_equal(eng.tables[key].numpy(), own[key].numpy()), (drop, key)
        assert np.array_equal(eng.access(ids), oracle.access(idx, ids))
        assert eng.iterator()[0] == idx.num_kmers


def test_refuses_weights_that_would_wrap():
    """The JAX engine casts the weight dictionary to uint32, which wraps
    weights >= 2^32; the port refuses such an index."""
    idx = synthetic.small_index("weighted")
    w = idx.weights
    big = dataclasses.replace(w, dictionary=np.append(w.dictionary[:-1], np.uint64(1 << 32)))
    with pytest.raises(ValueError, match="2\\^32"):
        StaticCfg(dataclasses.replace(idx, weights=big))
    with pytest.raises(ValueError, match="2\\^32"):
        device_arrays(dataclasses.replace(idx, weights=big))
    ok = dataclasses.replace(w, dictionary=np.append(w.dictionary[:-1],
                                                     np.uint64((1 << 32) - 1)))
    assert StaticCfg(dataclasses.replace(idx, weights=ok)).weighted


def test_refuses_formats_it_does_not_serve(monkeypatch, tmp_path):
    """The port raises where the JAX package raises: >= 2^32-1 kmers (ids
    are u32 with 0xFFFFFFFF as the sentinel), v1 rows at >= 2^32 chars,
    full lookup fields and streaming on v2 rows, and the two-round access
    form at >= 2^32 chars; and past its kernels' widest form, k > 255
    (a k = 65 index serves)."""
    idx = synthetic.small_index("m3_skew")
    k65 = synthetic.build_index(k=65, m=21, canonical=False, num_strings=4, string_len=100,
                                seed=1)
    assert StaticCfg(k65).W == 5
    with pytest.raises(ValueError, match="k <= 255"):
        StaticCfg(dataclasses.replace(k65, k=256))
    with pytest.raises(ValueError, match="2\\^32-1"):
        StaticCfg(dataclasses.replace(idx, num_kmers=(1 << 32) - 1))
    assert not StaticCfg(dataclasses.replace(idx, num_kmers=(1 << 32) - 2)).row_v2
    big = dataclasses.replace(idx, num_chars=1 << 32)
    assert StaticCfg(big).row_v2 and StaticCfg(big, "v2").row_v2
    with pytest.raises(ValueError, match="row_format='v1'"):
        StaticCfg(big, "v1")
    with pytest.raises(ValueError, match="row_format"):
        StaticCfg(idx, "v3")
    # v2 rows carry no string bounds: full fields raise, as in JAX
    eng = TorchEngine(idx, "cpu", row_format="v2")
    kt = eng.kmers32(oracle.access(idx, np.arange(8)))
    for make in (E.make_lookup, E.make_neighbours):
        with pytest.raises(ValueError, match="fields='ids'"):
            make(eng.cfg, "full")
    with pytest.raises(ValueError, match="fields='ids'"):
        kernels.probe_kernel(eng.cfg, eng.tables, kt, None, None, None)
    mv, mp = P.minimizer_plain(kt, idx.k, idx.m, eng.cfg.magic)
    with pytest.raises(ValueError, match="fields='ids'"):
        E.probe_plain(eng.cfg, eng.tables, kt, None, mv, mp)
    # ... and streaming raises on them
    path = str(tmp_path / "reads.fq")
    synthetic.write_reads(path, synthetic.index_strings(idx)[:2])
    with pytest.raises(ValueError, match="streaming needs full lookup fields"):
        ST.streaming_query_from_file(eng, path, device="cpu")
    with pytest.raises(ValueError, match="streaming needs full lookup fields"):
        ST.make_stream_step(eng.cfg, 1 << 16, 16, 1 << 14, eng._lookup_ids)
    # the two-round access form would read strings32 at wrapped offsets
    short = synthetic.small_index("short_strings")
    tables = TorchEngine(short, "cpu").tables
    ids = torch.arange(short.num_kmers, dtype=torch.int32)
    huge = StaticCfg(dataclasses.replace(short, num_chars=1 << 32))
    for fn in (E.access_plain, kernels.access_kernel):
        with pytest.raises(ValueError, match="windowed row form"):
            fn(huge, tables, ids)
    # the windowed form stays exact through u32 wrap-around, so it serves
    assert torch.equal(E.access_plain(StaticCfg(big), eng.tables, ids[:64]),
                       E.access_plain(eng.cfg, eng.tables, ids[:64]))
    # a v2 table dict from the JAX package is stale for a v1 engine
    monkeypatch.setenv("SSHASH_ROW_V2", "1")
    v2 = _device_arrays(jax_index(idx))
    monkeypatch.delenv("SSHASH_ROW_V2")
    with pytest.raises(ValueError, match="v1 rows"):
        TorchEngine(idx, "cpu", host_arrs=v2)
    assert TorchEngine(idx, "cpu", host_arrs=v2, row_format="v2").cfg.row_v2


def test_runs_with_jax_blocked():
    """The port imports neither JAX nor the JAX package: a process that can
    import neither builds an index with the port's own builder and looks
    it up, accesses, iterates, weighs, navigates and streams reads over it
    on the CPU, and ends with no jax or sshash_tpu module loaded."""
    code = textwrap.dedent("""
        import os
        import sys
        import tempfile

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "sshash_tpu"):
                    raise ImportError(f"{name} is blocked")

        sys.meta_path.insert(0, Block())
        import numpy as np
        from sshash_tpu_torch import Dictionary, oracle, synthetic, to_device
        from sshash_tpu_torch import streaming as ST

        rng = np.random.default_rng(0)
        with tempfile.TemporaryDirectory() as tmp:
            fa = os.path.join(tmp, "unitigs.fa")
            cfg = synthetic.write_input(fa, **synthetic.SMALL_CONFIGS["weighted"])
            d = Dictionary.build(fa, cfg)
            idx = d.index
            eng = to_device(idx, "cpu")
            ids = np.arange(0, idx.num_kmers, 7)
            km = oracle.access(idx, ids)
            got = eng.lookup(km)
            assert np.array_equal(got["kmer_id"], ids.astype(np.uint64))
            assert np.array_equal(eng.access(ids), km)
            assert eng.iterator()[0] == idx.num_kmers
            assert np.array_equal(eng.weight(ids), idx.weights.weight(ids))
            nb = eng.kmer_neighbours(km)
            assert (nb["kmer_id"] != np.uint64(2 ** 64 - 1)).any()
            strings = synthetic.index_strings(idx)
            fq = os.path.join(tmp, "reads.fq")
            synthetic.write_reads(fq, synthetic.cut_reads(strings, 40, 60, rng)
                                  + synthetic.random_reads(40, 60, rng))
            rep = ST.streaming_query_from_file(d, fq, device="cpu", chunk=1 << 16)
            rep.pop("elapsed_millisec")
            assert rep == ST.host_report(idx, fq) and rep["num_positive_kmers"] > 0
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "sshash_tpu"))
        assert not loaded, loaded
        print("ok", len(ids))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_to_device_accepts_dictionary_and_index():
    idx = synthetic.small_index("m9_c1")

    class Holder:  # a Dictionary-like wrapper
        index = idx

    for obj in (idx, Holder()):
        eng = to_device(obj, "cpu")
        assert eng.index is idx and eng.device.type == "cpu"
