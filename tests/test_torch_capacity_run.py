"""capacity_run.py and what it leans on, on the CPU at small sizes: the
port's streamed soak generator against the JAX package's scripts (byte for
byte), the chunked table build against device_arrays, the threaded ranged
assembly against the serial one, cached memory-mapped tables driving a CPU
TorchEngine to the JAX DeviceEngine's and the oracle's answers, the run's
ground-truth id rule against the oracle, its serve checks (ids rebased
above 2^31; a planted wrong id fails them) and its stage cache. All
outputs are integers: the tolerance is 0. Only the JAX comparison imports
JAX, so its `cuda` test runs on a card without it:

    python -m pytest --noconftest -m cuda tests/test_torch_capacity_run.py
"""

import contextlib
import functools
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sshash_tpu_torch import BuildConfig, TorchEngine, build, oracle, synthetic
from sshash_tpu_torch import kmer as K
from sshash_tpu_torch import layout as L
from sshash_tpu_torch.index import Index
from test_torch_host import assert_same_index, jax_index
from one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import capacity_run as CR  # noqa: E402
from soak_external import generate  # noqa: E402

BASE = (1 << 31) + 12345
INVALID = np.uint64(2 ** 64 - 1)
SOAK_KMERS = 250_000  # 3 strings of the soak at k31
CHUNK_CONFIGS = ("m13_regular", "m3_skew_canonical", "partitioned", "k63")


@pytest.mark.parametrize("k", [31, 65])
@pytest.mark.parametrize("num_kmers", [1, 99_970, 250_001])
def test_soak_bytes_equal_generate(tmp_path, num_kmers, k):
    with contextlib.redirect_stdout(io.StringIO()):
        want = generate(str(tmp_path / "jax.fa"), num_kmers, k)
    got = synthetic.write_soak(str(tmp_path / "port.fa"), num_kmers, k)
    assert got == want
    assert (tmp_path / "port.fa").read_bytes() == (tmp_path / "jax.fa").read_bytes()
    n = synthetic.soak_count(num_kmers, k)
    assert sum(1 for _ in synthetic.soak_strings(num_kmers, k)) == n


@functools.lru_cache(maxsize=None)
def small(name):
    return synthetic.small_index(name)


@pytest.mark.parametrize("chunk", ["string", "prime", "whole"])
@pytest.mark.parametrize("row_format", [None, "v2"])
@pytest.mark.parametrize("name", CHUNK_CONFIGS)
def test_chunked_tables_equal_device_arrays(tmp_path, name, row_format, chunk):
    """write_tables and device_arrays(chunk=) give device_arrays' arrays at
    chunks of one string, a prime number of chars and the whole index."""
    idx = small(name)
    chars = {"string": int(idx.string_endpoints[1]), "prime": 997,
             "whole": int(idx.num_chars)}[chunk]
    want = L.device_arrays(idx, row_format)
    specs = L.table_specs(idx, row_format)
    pieces = sum(-(-s.shape[0] // max(1, -(-s.shape[0] * chars // int(idx.num_chars))))
                 for s in specs.values() if not s.whole)
    assert pieces >= (len([s for s in specs.values() if not s.whole])
                      * (2 if chunk != "whole" else 1))
    got = L.write_tables(idx, str(tmp_path / "t"), row_format, chunk=chars, threads=3)
    mem = L.device_arrays(idx, row_format, chunk=chars, threads=2)
    assert set(got) == set(want) == set(mem)
    for key, v in want.items():
        assert isinstance(got[key], np.memmap), key
        assert got[key].dtype == v.dtype == mem[key].dtype == np.uint32, key
        assert np.array_equal(got[key], v), f"{name} {row_format} {chunk}: {key}"
        assert np.array_equal(mem[key], v), f"{name} {row_format} {chunk}: {key}"


@functools.lru_cache(maxsize=None)
def soak_index(tmp_root):
    path = os.path.join(tmp_root, "soak.fa")
    synthetic.write_soak(path, SOAK_KMERS, 31)
    cfg = BuildConfig(k=31, m=17, verbose=False, ram_limit_mb=1, tmp_dir=tmp_root,
                      avg_partition_size=10_000)
    return build(path, cfg)


@pytest.fixture(scope="module")
def soak(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("soak"))
    idx = soak_index(root)
    src = CR.Strings.soak(SOAK_KMERS, 31)
    gt = CR.ground_truth(src, 31, lanes=1 << 12, reads=64, threads=2)
    return root, idx, src, gt


def test_threaded_ranged_assembly_equals_serial(soak):
    """The ranged assembly on 4 threads (partitions and hash ranges in
    parallel) builds the serial build's arrays, over many MPHF
    partitions."""
    root, idx, _, _ = soak
    assert idx.minimizer_mphf.num_partitions >= 4
    cfg = BuildConfig(k=31, m=17, verbose=False, ram_limit_mb=1, tmp_dir=root,
                      avg_partition_size=10_000, threads=4)
    assert_same_index(build(os.path.join(root, "soak.fa"), cfg), idx)


def test_ground_truth_ids_equal_oracle(soak):
    """The run's id rule (string * (length - k + 1) + position, in file
    order) and its k-mers equal the oracle's lookup and access; its
    checksum equals the iteration's over the oracle's k-mers."""
    _, idx, _, gt = soak
    assert gt["num_kmers"] == idx.num_kmers
    want = oracle.lookup(idx, gt["query"])
    assert np.array_equal(want["kmer_id"].astype(np.int64), gt["ids"])
    assert np.array_equal(want["kmer_orientation"], gt["orientation"])
    assert np.array_equal(want["string_id"].astype(np.int64), gt["sid"])
    assert np.array_equal(oracle.access(idx, gt["ids"]), gt["fwd"])
    words = K.kmers_to_u32(oracle.access(idx, np.arange(idx.num_kmers)), idx.k)
    chk = int(np.bitwise_xor.reduce(words, axis=1).astype(np.uint64).sum()) & 0xFFFFFFFF
    assert gt["checksum"] == chk
    eng = TorchEngine(idx, "cpu")
    assert [int(x) for x in eng.iterator()] == [idx.num_kmers, chk]


@pytest.mark.parametrize("row_format", [None, "v2"])
def test_mmap_tables_equal_jax_and_oracle(soak, tmp_path, monkeypatch, row_format):
    """Tables written by the tables stage and loaded with mmap_mode="r"
    drive a CPU TorchEngine to the JAX DeviceEngine's answers (v2 rows
    with SSHASH_ROW_V2=1) and the oracle's: lookup, membership, access,
    iteration."""
    from sshash_tpu.engine import DeviceEngine  # imports JAX: the card tests below do not

    _, idx, _, gt = soak
    arrs = CR.tables_stage(idx, str(tmp_path / "t"), row_format, chunk=50_000, threads=2)
    meta = json.loads((tmp_path / "t" / "meta.json").read_text())
    assert meta["row_v2"] == (row_format == "v2") and meta["num_kmers"] == idx.num_kmers
    assert all(isinstance(v, np.memmap) for v in arrs.values())
    eng = TorchEngine(idx, "cpu", host_arrs=arrs, row_format=row_format)
    if row_format == "v2":
        monkeypatch.setenv("SSHASH_ROW_V2", "1")
    jeng = DeviceEngine(jax_index(idx))
    q = np.concatenate([gt["query"][:1024], gt["negatives"][:1024]])
    got, jgot, want = eng.lookup(q), jeng.lookup(q), oracle.lookup(idx, q)
    assert set(got) <= set(jgot)
    for key in got:
        assert np.array_equal(got[key], jgot[key]), key
        assert np.array_equal(got[key], want[key]), key
    assert np.array_equal(eng.is_member(q), jeng.is_member(q))
    ids = gt["ids"][:2048]
    assert np.array_equal(eng.access(ids), jeng.access(ids))
    assert np.array_equal(eng.access(ids), gt["fwd"][:2048])
    jcount, jchecksum = (int(np.asarray(x)) for x in jeng._iterator(jeng.arrs))
    assert [int(x) for x in eng.iterator()] == [jcount, jchecksum] == [idx.num_kmers,
                                                                         gt["checksum"]]


def _serve(idx, gt, src, tmp_path, row_format=None, base=0, above=(), wrap=None):
    eng = TorchEngine(idx, "cpu", row_format=row_format)
    if base:
        eng.tables = synthetic.rebase_ids(eng.cfg, eng.tables, base)
    if wrap:
        wrap(eng)
    logged = []
    summary, checks, _ = CR.serve_checks(eng, gt, src, id_base=base, nav_lanes=512,
                                         nav_sample=64, workdir=str(tmp_path), threads=2,
                                         above=above, log=logged.append)
    return summary, checks, logged


def test_serve_checks_pass_v1(soak, tmp_path):
    _, idx, src, gt = soak
    summary, checks, logged = _serve(idx, gt, src, tmp_path)
    checks.raise_any()
    names = {r["check"] for r in logged if "check" in r}
    assert {"positives", "positives_full_fields", "negatives", "is_member", "access",
            "navigation", "iteration", "streaming"} <= names
    assert summary["positive_ids_exact"] == summary["positives_checked"] == len(gt["ids"])
    assert summary["negatives_found"] == 0
    # ids below 2^31 fail a check that needs lanes above it
    checks = CR.Checks("v1", logged.append, above=("access",))
    checks.record("access", True, ids_at_or_above_2_31=0)
    checks.record("navigation", True, ids_at_or_above_2_31=0)
    assert [f["check"] for f in checks.failures] == ["access"]


def test_serve_checks_rebased_above_2_31(soak, tmp_path):
    """v2 rows rebased by 2^31 + 12345: every lookup and navigation answer
    lands at or above 2^31, the checks count those lanes and pass, and a
    single planted wrong id fails them."""
    _, idx, src, gt = soak
    above = ("positives", "navigation")
    summary, checks, logged = _serve(idx, gt, src, tmp_path, "v2", BASE, above)
    checks.raise_any()
    rec = {r["check"]: r for r in logged if "check" in r}
    assert rec["positives"]["ids_at_or_above_2_31"] == len(gt["ids"])
    assert rec["navigation"]["ids_at_or_above_2_31"] > 0
    assert rec["streaming_refused"]["ok"]
    assert summary["row_format"] == "v2_rebased"

    def plant(eng):
        lookup = eng.lookup_ids_device

        def wrong(kt):
            res = dict(lookup(kt))
            res["kmer_id"] = res["kmer_id"].clone()
            res["kmer_id"][7] += 1
            return res
        eng.lookup_ids_device = wrong

    _, checks, _ = _serve(idx, gt, src, tmp_path, "v2", BASE, above, wrap=plant)
    assert [f["check"] for f in checks.failures] == ["positives"]
    assert checks.failures[0]["ids_exact"] == len(gt["ids"]) - 1
    with pytest.raises(CR.CapacityError):
        checks.raise_any()


def test_serve_checks_negative_in_strings(soak, tmp_path):
    """A random k-mer that is in the strings is found and accepted once the
    strings hold it at the returned id; a positive answered by the wrong
    string is not."""
    _, idx, src, gt = soak
    gt2 = dict(gt, negatives=gt["negatives"].copy())
    gt2["negatives"][3] = gt["fwd"][5]
    _, checks, logged = _serve(idx, gt2, src, tmp_path)
    checks.raise_any()
    neg = next(r for r in logged if r.get("check") == "negatives")
    assert neg["found"] == neg["present_in_strings"] == 1


def test_stages_reuse_their_output(tmp_path):
    """generate, build and tables each run once in a child process with
    their JSON line; a second run reuses every one of them."""
    argv = [sys.executable, os.path.join(REPO, "capacity_run.py"), "--kmers", "120000",
            "--workdir", str(tmp_path), "--stages", "generate,build,tables", "--ram-mb", "1",
            "--scan-procs", "1", "--threads", "2", "--chunk", "30000"]
    env = dict(os.environ, PYTHONPATH=REPO)
    first = subprocess.run(argv, capture_output=True, text=True, env=env, check=True)
    recs = [json.loads(x) for x in first.stdout.splitlines() if x.startswith("{")]
    host = recs.pop(0)
    assert host["stage"] == "host" and host["cores"] >= 1 and host["mem_total_gib"] > 0
    stages = [(r["stage"], r.get("row_format")) for r in recs]
    assert stages == [("generate", None), ("build", None), ("tables", "v1")]
    assert all("sec" in r and r["peak_rss_mb"] > 0 and not r.get("reused") for r in recs)
    assert recs[1]["num_kmers"] == 2 * 99970  # two strings of the soak
    mtimes = {f: os.path.getmtime(tmp_path / f) for f in os.listdir(tmp_path)}
    second = subprocess.run(argv, capture_output=True, text=True, env=env, check=True)
    again = [json.loads(x) for x in second.stdout.splitlines() if x.startswith("{")][1:]
    assert [(r["stage"], r.get("row_format")) for r in again] == stages
    assert all(r["reused"] for r in again)
    assert {f: os.path.getmtime(tmp_path / f) for f in os.listdir(tmp_path)} == mtimes
    idx = Index.load(str(tmp_path / "index_120000_k31_m17"))
    arrs = L.load_tables(str(tmp_path / "tables_120000_k31_m17_v1"))
    want = L.device_arrays(idx)
    assert all(np.array_equal(arrs[key], v) for key, v in want.items())
    assert torch.equal(TorchEngine(idx, "cpu", host_arrs=arrs).tables["cw_row"],
                       torch.from_numpy(want["cw_row"].view(np.int32)))


@pytest.mark.parametrize("name", ["m13_canonical", "m13_regular"])
def test_serve_checks_on_write_input_strings(tmp_path, name):
    """chip_smoke's capacity phase at a small size: write_input's strings
    (synthetic.string_codes) as the ground truth of a canonical and a
    regular index; the tables stage in 8 pieces a table equals
    device_arrays; v1 and v2 rebased above 2^31 pass the serve checks."""
    cfg = synthetic.SMALL_CONFIGS[name]
    idx = small(name)
    n, length = cfg["num_strings"], cfg["string_len"]
    src = CR.Strings(n, length, lambda: iter([
        (0, synthetic.string_codes(n, length, cfg["seed"])[1])]))
    gt = CR.ground_truth(src, idx.k, lanes=1 << 11, reads=32, threads=2)
    assert gt["num_kmers"] == idx.num_kmers
    chunk = -(-int(idx.num_chars) // 8)
    arrs = CR.tables_stage(idx, str(tmp_path / "v1"), None, chunk, 2)
    want = L.device_arrays(idx)
    assert set(arrs) == set(want) and all(np.array_equal(arrs[key], v)
                                          for key, v in want.items())
    for rf, base, above in ((None, 0, ()), ("v2", BASE, ("positives", "navigation"))):
        if rf:
            arrs = CR.tables_stage(idx, str(tmp_path / rf), rf, chunk, 2)
        eng = TorchEngine(idx, "cpu", host_arrs=arrs, row_format=rf)
        if base:
            eng.tables = synthetic.rebase_ids(eng.cfg, eng.tables, base)
        logged = []
        summary, checks, _ = CR.serve_checks(eng, gt, src, id_base=base, nav_lanes=256,
                                             nav_sample=64, workdir=str(tmp_path), threads=2,
                                             above=above, log=logged.append)
        checks.raise_any()
        assert summary["positive_ids_exact"] == len(gt["ids"])


def test_sharded_checks_equal_single_engine(soak, tmp_path):
    """A ShardedEngine on LocalMesh((1, 4)) over the tables stage's tables
    answers as the single engine does: ids lookup, access, navigation."""
    _, idx, src, gt = soak
    arrs = CR.tables_stage(idx, str(tmp_path / "t"), None, 50_000, 2)
    eng = TorchEngine(idx, "cpu", host_arrs=arrs)
    logged = []
    _, checks, answers = CR.serve_checks(eng, gt, src, nav_lanes=256, nav_sample=32,
                                         workdir=str(tmp_path), log=logged.append)
    checks.raise_any()
    summary, sc = CR.sharded_checks(idx, arrs, answers, gt, "cpu", log=logged.append)
    sc.raise_any()
    assert summary["fits"] and summary["mesh"] == [1, 4]
    assert [r["check"] for r in logged if r.get("engine") == "sharded" and "check" in r] == [
        "sharded_lookup", "sharded_access", "sharded_navigation"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the upload in pieces goes through pinned memory "
                    "to a card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["m13_regular", "m3_skew_canonical"])
def test_upload_in_pieces_on_card(card, tmp_path, name):
    """Memory-mapped tables uploaded a few rows at a time through a small
    pinned piece (their pages released as they land) equal the tables, and
    an engine over them answers as one over device_arrays."""
    idx = small(name)
    arrs = L.write_tables(idx, str(tmp_path / "t"), chunk=997, threads=2)
    stage = torch.empty(1024, dtype=torch.int32, pin_memory=True)
    for key, v in arrs.items():
        got = L.upload(v, card, stage)
        assert torch.equal(got.cpu(), torch.from_numpy(np.array(v).view(np.int32))), key
    q, _ = synthetic.query_batch(idx)
    a, b = TorchEngine(idx, card, host_arrs=arrs), TorchEngine(idx, card)
    got, want = a.lookup(q), b.lookup(q)
    assert all(np.array_equal(got[key], want[key]) for key in want)
