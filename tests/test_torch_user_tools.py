"""The port's user tools (sshash_tpu_torch/tools/: sweep_m, sweep_min_l,
soak_mphf, demo) against the JAX repo's scripts of the same names on the
same small inputs: the same JSON lines but the times, the demo's printed
lines, and its values against the JAX package's own calls; then each as
`python -m sshash_tpu_torch.tools.<name>` in a process that can import
neither JAX nor the JAX package."""

import contextlib
import gzip
import importlib.util
import io
import json
import os
import runpy
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from sshash_tpu import BuildConfig as JBuildConfig
from sshash_tpu import Dictionary as JDictionary
from sshash_tpu import mphf as jmphf
from sshash_tpu.check import check_all as jcheck_all
from sshash_tpu.cover import permute_file as jpermute_file
from sshash_tpu.oracle import access as jaccess
from sshash_tpu.streaming import streaming_query_from_file as jstreaming_query_from_file
from sshash_tpu_torch import BuildConfig, build, synthetic
from sshash_tpu_torch.tools import demo, soak_mphf, sweep_m
from test_torch_tools import BLOCKED, PROBE
from one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
# 32 strings of 1,001 chars: 31,072 k31 kmers; at m4 MIN_L 4 and 6 leave
# heavy buckets in 4 and 2 partitions
SWEEP = dict(k=31, m=13, canonical=False, num_strings=32, string_len=1001, seed=61)
# the demo's inputs, cut to size: 19,400 unitig kmers (more than the id
# 12345 it accesses), 60 weighted strings with runs of mean 30
DEMO_SHAPES = {"unitigs": dict(num_strings=20, string_len=1000, seed=41),
               "reads": dict(num_reads=200, read_len=76, n_frac=0.05, seed=42),
               "weighted": dict(num_strings=60, string_len=400, seed=43, weights=30)}


def _stdout(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def _rows(text):
    """The lines of text, JSON lines parsed and without their times (the
    index build's warnings stay as text)."""
    rows = [json.loads(ln) if ln.startswith("{") else ln for ln in text.strip().splitlines()]
    for r in rows:
        for key in ("build_sec", "gen_sec", "ns_per_key", "eval_sec_2M"):
            if isinstance(r, dict):
                r.pop(key, None)
    return rows


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sweep") / "unitigs.fa")
    synthetic.write_input(path, **SWEEP)
    return path


def _probe_env(tmp_path):
    """(env, records dir) of the blocked interpreters of test_torch_tools,
    torch on one thread in them as in this process (one_thread.py: the
    suite's workers share the cores)."""
    probe, records = tmp_path / "probe", tmp_path / "records"
    probe.mkdir()
    records.mkdir()
    (probe / "sitecustomize.py").write_text(PROBE % (BLOCKED, BLOCKED, str(records)))
    return dict(os.environ, PYTHONPATH=os.pathsep.join([str(probe), REPO]),
                OMP_NUM_THREADS="1"), records


def _records(records):
    return [json.loads(p.read_text()) for p in records.iterdir()]


# ---------------------------------------------------------------- sweep_m


@pytest.mark.parametrize("flags", [["--m-values", "13,15"],
                                   ["--m-values", "11,13", "--canonical"],
                                   ["-k", "15"]], ids=["regular", "canonical", "default_m"])
def test_sweep_m_equals_jax(fasta, flags, monkeypatch):
    argv = ["-i", fasta] + flags
    got = _rows(_stdout(sweep_m.main, argv))
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(sys, "argv", ["sweep_m.py"] + argv)
    want = _rows(_stdout(runpy.run_path, os.path.join(SCRIPTS, "sweep_m.py"), None,
                         "__main__"))
    assert got == want
    got = [r for r in got if isinstance(r, dict)]
    # k15's default range is m = 7 alone: range(max(7, k - 18), k - 7, 2)
    ms = [7] if "-k" in flags else [int(x) for x in flags[1].split(",")]
    assert [r["m"] for r in got] == ms
    assert all(r["num_kmers"] > 0 and r["bits_per_kmer"] > 0 for r in got)


# ------------------------------------------------------------ sweep_min_l


def test_sweep_min_l_equals_jax(fasta, tmp_path):
    """Both scripts at MIN_L 4 and 6 and a bad one, 0: equal rows but the
    times, and the same error; the port's children (blocked interpreters)
    load neither JAX nor torch."""
    argv = ["-i", fasta, "-k", "31", "-m", "4", "--l-values", "4,6,0"]
    env, records = _probe_env(tmp_path)
    got = subprocess.run([sys.executable, "-m", "sshash_tpu_torch.tools.sweep_min_l"] + argv,
                         env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    want = subprocess.run([sys.executable, os.path.join(SCRIPTS, "sweep_min_l.py")] + argv,
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert got.returncode == want.returncode == 0, (got.stderr[-2000:], want.stderr[-2000:])
    got, want = _rows(got.stdout), _rows(want.stdout)
    assert [r["min_l"] for r in got] == [4, 6, 0]
    assert got[:2] == want[:2]
    assert got[0]["num_heavy_positions"] > got[1]["num_heavy_positions"] > 0
    assert got[0]["num_heavy_partitions"] > got[1]["num_heavy_partitions"] > 0
    assert [r["max_l"] for r in got[:2]] == [11, 13]
    bad, jbad = got[2], want[2]
    assert set(bad) == set(jbad) == {"min_l", "error"}
    assert bad["error"].splitlines()[-1] == jbad["error"].splitlines()[-1]
    assert "need MIN_L <= MAX_L" in bad["error"]
    recs = _records(records)
    assert len(recs) == 4 and all(r["loaded"] == [] and not r["torch"] for r in recs)
    assert sum(r["argv"][0] == "-c" for r in recs) == 3


# -------------------------------------------------------------- soak_mphf


def test_soak_mphf_equals_jax():
    n = 10 ** 5
    lines = _stdout(soak_mphf.main, ["--keys", str(n)]).strip().splitlines()
    keys, sample, pos, row = soak_mphf.soak(n)
    assert set(json.loads(lines[0])) == {"gen_sec"}
    # scripts/soak_mphf.py's keys and sample at n keys (its sample is 2M
    # of 100M; at 10^5 every key, in a random order)
    rng = np.random.default_rng(99)
    jkeys = np.unique(rng.integers(0, 1 << 63, int(n * 1.01), dtype=np.uint64))[:n]
    assert np.array_equal(keys, jkeys)
    assert np.array_equal(sample, rng.choice(n, n, replace=False))
    jf = jmphf.PartitionedMPHF.build_u64(jkeys, seed=1)
    jpos = jf(jkeys[sample])
    assert np.array_equal(pos, jpos)
    want = {"n_keys": n, "partitions": jf.num_partitions,
            "bits_per_key": round(jf.num_bits() / n, 2),
            "sampled_positions_distinct": len(np.unique(jpos)) == len(sample),
            "in_range": bool((jpos >= 0).all() and (jpos < n).all())}
    assert _rows(lines[-1]) == _rows(json.dumps(row)) == [want]
    assert list(row) == ["n_keys", "partitions", "build_sec", "ns_per_key", "bits_per_key",
                         "eval_sec_2M", "sampled_positions_distinct", "in_range"]
    assert row["sampled_positions_distinct"] and row["in_range"]


# ------------------------------------------------------------------- demo


def _gzip(plain, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(plain, "rb") as f, gzip.open(path, "wb") as g:
        shutil.copyfileobj(f, g)


@pytest.fixture(scope="module")
def demo_data(tmp_path_factory):
    """The reference's data layout at small size: the unitigs and the
    weighted unitigs as the demo's stand-ins write them, and reads half cut
    from the unitigs (a quarter reverse-complemented, 1% substitutions),
    half random, an N in 5%."""
    tmp = tmp_path_factory.mktemp("demo_data")
    for name in ("unitigs", "weighted"):
        demo.write_stand_in(name, str(tmp / demo.INPUTS[name]), DEMO_SHAPES[name])
    idx = build(str(tmp / demo.INPUTS["unitigs"]), BuildConfig(k=31, m=13, verbose=False))
    rng = np.random.default_rng(7)
    reads = synthetic.cut_reads(synthetic.index_strings(idx), 100, 76, rng, rc=0.25,
                                subst=0.01) + synthetic.random_reads(100, 76, rng)
    plain = str(tmp / "reads.fq")
    synthetic.write_reads(plain, synthetic.with_n(reads, 0.05, rng))
    _gzip(plain, str(tmp / demo.INPUTS["reads"]))
    return str(tmp)


@pytest.fixture(scope="module")
def port_demo(demo_data):
    """(printed text, values) of the port's demo on the CPU."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        values = demo.run(demo_data, "cpu")
    return out.getvalue(), values


def _jax_demo(monkeypatch):
    spec = importlib.util.spec_from_file_location("jax_demo", os.path.join(SCRIPTS, "demo.py"))
    module = importlib.util.module_from_spec(spec)
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec.loader.exec_module(module)
    return module


def test_demo_prints_jax_lines(demo_data, port_demo, monkeypatch):
    jd = _jax_demo(monkeypatch)
    monkeypatch.setattr(jd, "DATA", demo_data)
    text = _stdout(jd.main)
    assert port_demo[0] == text
    assert text.startswith("== Example 1") and text.endswith("all good.\n")


def test_demo_values_equal_the_jax_package(demo_data, port_demo, tmp_path):
    values = port_demo[1]
    path = {name: os.path.join(demo_data, rel) for name, rel in demo.INPUTS.items()}
    jd = JDictionary.build(path["unitigs"], JBuildConfig(k=31, m=13, verbose=False))
    n = jd.num_kmers()
    ids = np.array([0, 1, 12345, n - 1])
    assert values["num_kmers"] == n == 20 * (1000 - 30)
    assert values["ids"] == ids.tolist()
    assert values["kmers"] == jd.access(ids, as_strings=True)
    assert values["lookup_ids"] == jd.lookup(values["kmers"])["kmer_id"].tolist() == ids.tolist()
    assert values["is_member"] == jd.is_member(values["kmers"]).tolist() == [True] * 4
    nb = jd.kmer_neighbours(jaccess(jd.index, ids[:1]))
    assert values["forward_neighbours"] == nb["forward"]["kmer_id"][0].tolist()
    assert 1 in values["forward_neighbours"]  # kmer 0's successor in its string
    rep = jstreaming_query_from_file(jd, path["reads"], use_device=False)
    rep.pop("elapsed_millisec")
    assert values["stream"] == rep
    assert 0 < rep["num_positive_kmers"] < rep["num_kmers"] == 200 * (76 - 30)
    assert rep["num_invalid_kmers"] > 0
    assert values["check"] and jcheck_all(jd, verbose=False)
    out = str(tmp_path / "permuted.fa")
    stats = jpermute_file(path["weighted"], 31, out)
    assert values["permute"] == stats and stats["final_runs"] < stats["initial_runs"]
    dw = JDictionary.build(out, JBuildConfig(k=31, m=13, weighted=True, verbose=False))
    assert values["weights"] == dw.weight(np.arange(8)).tolist()
    assert set(values["seconds"]) == {"build", "queries", "stream", "check", "permute",
                                      "weighted"}


def test_demo_writes_stand_ins_for_absent_data(demo_data, port_demo, tmp_path):
    """Only the reads in DIR: the unitigs and the weighted unitigs are the
    stand-ins, written from their seeds as the fixture's were, so every
    value equals the run on the fixture's files."""
    rel = demo.INPUTS["reads"]
    os.makedirs(os.path.dirname(tmp_path / rel))
    shutil.copy(os.path.join(demo_data, rel), tmp_path / rel)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        values = demo.run(str(tmp_path), "cpu", DEMO_SHAPES)
    lines = out.getvalue().splitlines()
    assert [ln.split(":")[0] for ln in lines[:2]] == [
        f"stand-in for {demo.INPUTS['unitigs']}", f"stand-in for {demo.INPUTS['weighted']}"]
    assert "\n".join(lines[2:]) + "\n" == port_demo[0]
    values.pop("seconds")
    assert values == {key: v for key, v in port_demo[1].items() if key != "seconds"}
    assert sorted(os.listdir(tmp_path)) == ["queries"]  # the stand-ins went to a temporary dir
    # the full-size stand-ins: 5M unitig kmers, 460,000 read kmers, Sakai's shape
    shapes = demo.STAND_INS
    assert shapes["unitigs"]["num_strings"] * (shapes["unitigs"]["string_len"] - 30) == 5_000_000
    assert shapes["reads"]["num_reads"] * (shapes["reads"]["read_len"] - 30) == 460_000
    assert (shapes["weighted"]["num_strings"], shapes["weighted"]["string_len"],
            shapes["weighted"]["weights"]) == (2115, 2630, synthetic.ECOLI_SAKAI_MEAN_RUN)


def test_demo_has_no_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        demo.main(["--data", str(tmp_path)])
    assert os.listdir(tmp_path) == []


# ------------------------------------------------------ blocked interpreters


def test_tools_run_as_modules_with_jax_blocked(fasta, demo_data, port_demo, tmp_path):
    """sweep_m, soak_mphf and the demo (--device cpu) as python -m, each in
    a process that can import neither JAX nor the JAX package and loads
    neither; the sweep and the soak never load torch. The demo's lines and
    --json values equal the in-process run's."""
    env, records = _probe_env(tmp_path)
    values = str(tmp_path / "values.json")
    runs = {"sweep_m": ["-i", fasta, "--m-values", "13"],
            "soak_mphf": ["--keys", "20000"],
            "demo": ["--data", demo_data, "--device", "cpu", "--json", values]}
    outs = {}
    for name, argv in runs.items():
        out = subprocess.run([sys.executable, "-m", f"sshash_tpu_torch.tools.{name}"] + argv,
                             env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, (name, out.stderr[-2000:])
        outs[name] = out.stdout
    assert _rows(outs["sweep_m"]) == _rows(_stdout(sweep_m.main, runs["sweep_m"]))
    assert outs["demo"] == port_demo[0]
    with open(values) as f:
        got = json.load(f)
    got.pop("seconds")
    assert got == {key: v for key, v in port_demo[1].items() if key != "seconds"}
    recs = {r["argv"][0].rsplit(os.sep, 1)[-1]: r for r in _records(records)}
    assert sorted(recs) == ["demo.py", "soak_mphf.py", "sweep_m.py"]
    assert all(r["loaded"] == [] for r in recs.values())
    assert [name for name, r in sorted(recs.items()) if r["torch"]] == ["demo.py"]
