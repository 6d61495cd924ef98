"""The port's host tooling against the JAX package's: info (space
breakdown, info text), the check suite with the port's engine, permute
(the weight-run cover) and the CLI (build, check, query, bench, permute;
`python -m sshash_tpu_torch` in a process that can import neither JAX nor
the JAX package)."""

import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from sshash_tpu import check as jcheck
from sshash_tpu import cover as jcover
from sshash_tpu import info as jinfo
from sshash_tpu.tools import cli as jcli
from sshash_tpu_torch import Dictionary, TorchEngine, build, check, cover, info, oracle, synthetic
from sshash_tpu_torch import kmer as K
from sshash_tpu_torch.builder.parse import parse_input
from sshash_tpu_torch.tools import cli
from test_torch_host import jax_index

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INVALID = np.uint64(2 ** 64 - 1)
BLOCKED = ("jax", "jaxlib", "sshash_tpu")


def _index(name):
    return synthetic.small_index(name)


# ----------------------------------------------------------------- info


@pytest.mark.parametrize("name", ["m13_regular", "weighted", "m3_skew", "partitioned", "k65"])
def test_info_equals_jax(name):
    idx = _index(name)
    jidx = jax_index(idx)
    assert info.space_breakdown(idx) == jinfo.space_breakdown(jidx)
    assert info.actual_space_breakdown(idx) == jinfo.actual_space_breakdown(jidx)
    assert info.info_dict(idx) == jinfo.info_dict(jidx)
    assert idx.num_bits_actual() == jidx.num_bits_actual()
    assert idx.num_bits_actual() == sum(info.actual_space_breakdown(idx).values())
    out, jout = io.StringIO(), io.StringIO()
    assert info.print_info(idx, out=out) == jinfo.print_info(jidx, out=jout)
    assert out.getvalue() == jout.getvalue() and "SPACE BREAKDOWN" in out.getvalue()


def test_dictionary_prints_info(capsys):
    d = Dictionary(_index("weighted"))
    d.print_info()
    text = capsys.readouterr().out
    d.print_space_breakdown()
    assert capsys.readouterr().out in text
    assert json.loads(text.strip().splitlines()[-1])["weighted"] is True


# ---------------------------------------------------------------- check


@pytest.mark.parametrize("name", ["m13_canonical", "m3_skew_canonical", "partitioned", "k63",
                                  "k65", "short_strings", "v2_rows"])
def test_check_all_with_the_port_engine(name):
    idx = _index("m13_regular" if name == "v2_rows" else name)
    eng = TorchEngine(idx, "cpu", row_format="v2" if name == "v2_rows" else None)
    assert eng.cfg.row_v2 == (name == "v2_rows")
    assert check.check_all(Dictionary(idx), engine=eng)


@pytest.mark.parametrize("name,num", [("m13_canonical", 1 << 16), ("k15", 1 << 18)])
def test_negative_lookup_hits_equal_jax(name, num):
    idx = _index(name)
    hits = check.check_negative_lookups(idx, num=num, seed=3, engine=TorchEngine(idx, "cpu"))
    assert hits == jcheck.check_negative_lookups(jax_index(idx), num=num, seed=3)
    assert hits == check.check_negative_lookups(idx, num=num, seed=3)
    if name == "k15":  # 5,504 of 4^15 kmers: 2^18 random ones find a few
        assert hits > 0


class _Faulty:
    """A TorchEngine whose answers are wrong on one lane of each batch."""

    def __init__(self, eng, fault):
        self.eng, self.fault = eng, fault

    def lookup(self, kmers):
        res = self.eng.lookup(kmers)
        if self.fault == "id":
            res["kmer_id"][5] += np.uint64(1)
        elif self.fault == "orientation":
            res["kmer_orientation"][7] ^= 1
        return res

    def kmer_neighbours(self, kmers):
        res = self.eng.kmer_neighbours(kmers)
        if self.fault == "neighbour":
            res["kmer_id"][3] = INVALID
        return res


@pytest.mark.parametrize("fault,what", [("id", check.check_dictionary),
                                        ("orientation", check.check_dictionary),
                                        ("neighbour", check.check_navigation)])
def test_check_catches_a_wrong_lane(fault, what):
    idx = _index("m13_regular")
    eng = TorchEngine(idx, "cpu")
    args = (idx,) if what is check.check_dictionary else (idx, Dictionary(idx))
    assert what(*args, engine=_Faulty(eng, None))
    with pytest.raises(AssertionError):
        what(*args, engine=_Faulty(eng, fault))


def test_check_weights(tmp_path):
    path = str(tmp_path / "w.fa")
    cfg = synthetic.write_input(path, **synthetic.SMALL_CONFIGS["weighted"])
    d = Dictionary.build(path, cfg)
    parsed = parse_input(path, cfg.k, weighted=True)
    assert check.check_weights(d.index, (parsed.weight_interval_values,
                                         parsed.weight_interval_lengths))
    vals = parsed.weight_interval_values.copy()
    vals[1] += 1
    with pytest.raises(AssertionError):
        check.check_weights(d.index, (vals, parsed.weight_interval_lengths))


# -------------------------------------------------------------- permute

# E. coli Sakai's shape (synthetic.ECOLI_SAKAI_MEAN_RUN: 2,115 unitigs of
# about 2,630 chars, weight runs of mean 945), cut to 200 strings
SAKAI_SMALL = dict(k=31, m=13, canonical=False, num_strings=200, string_len=2630, seed=14,
                   weights=synthetic.ECOLI_SAKAI_MEAN_RUN)


def _global_runs(path):
    """Weight runs across the whole file in order."""
    runs, prev = 0, None
    with open(path, "rb") as f:
        for header in f.read().split(b"\n")[::2]:
            if not header:
                continue
            for w in header[header.index(b"ab:Z:") + 5:].split():
                runs += w != prev
                prev = w
    return runs


def _canonical_kmers(path, k):
    parsed = parse_input(path, k, weighted=False)
    words = K.pack_codes(parsed.codes, pad_words=K.num_words64(k) + 1)
    ep = parsed.endpoints.astype(np.int64)
    offs = np.concatenate([np.arange(ep[s], ep[s + 1] - k + 1) for s in range(len(ep) - 1)])
    km = K.read_kmers_at(words, offs, k)
    return np.sort(np.minimum(km[:, 0], K.revcomp_kmers(km, k)[:, 0]))


@pytest.fixture(scope="module")
def sakai(tmp_path_factory):
    """(input path, its BuildConfig, permuted path, stats)."""
    tmp = tmp_path_factory.mktemp("sakai")
    path, out = str(tmp / "sakai.fa"), str(tmp / "sakai.perm.fa")
    cfg = synthetic.write_input(path, **SAKAI_SMALL)
    return path, cfg, out, cover.permute_file(path, cfg.k, out)


def test_permute_equals_jax(sakai, tmp_path):
    path, cfg, out, stats = sakai
    jout = str(tmp_path / "jax.perm.fa")
    assert jcover.permute_file(path, cfg.k, jout) == stats
    with open(out, "rb") as f, open(jout, "rb") as g:
        assert f.read() == g.read()
    assert stats["num_sequences"] == SAKAI_SMALL["num_strings"]
    # initial_runs counts each string's runs alone; the file's runs may
    # join across string ends
    assert stats["final_runs"] < stats["initial_runs"]
    assert _global_runs(path) <= stats["initial_runs"]
    assert _global_runs(out) == stats["final_runs"]
    assert stats["final_runs"] == (stats["initial_runs"] - stats["num_sequences"]
                                   + stats["num_walks"])


def test_permutation_is_a_bijection(sakai):
    path, cfg, _, stats = sakai
    data = cover.parse_weighted_headers(path, cfg.k)
    perm, signs, walks = cover.Cover(data).compute().permutation_and_signs()
    assert sorted(perm.tolist()) == list(range(data.num_sequences))
    assert walks == stats["num_walks"] and not signs.all()


def test_permute_keeps_kmers_and_weights(sakai):
    path, cfg, out, stats = sakai
    assert np.array_equal(_canonical_kmers(path, cfg.k), _canonical_kmers(out, cfg.k))
    orig, perm = build(path, cfg), build(out, cfg)
    assert len(perm.weights.interval_value_ids) == stats["final_runs"]
    assert len(orig.weights.interval_value_ids) == _global_runs(path)
    ids = np.arange(orig.num_kmers)
    res = oracle.lookup(perm, oracle.access(orig, ids))
    assert (res["kmer_id"] != INVALID).all()
    assert np.array_equal(perm.weights.weight(res["kmer_id"].astype(np.int64)),
                          orig.weights.weight(ids))


# ------------------------------------------------------------------ CLI


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """(weighted FASTA, reads FASTQ, saved index) in one directory."""
    tmp = tmp_path_factory.mktemp("cli")
    fa, fq, saved = str(tmp / "w.fa"), str(tmp / "reads.fq"), str(tmp / "w.idx")
    cfg = synthetic.write_input(fa, **dict(synthetic.SMALL_CONFIGS["weighted"],
                                           num_strings=128))
    strings = synthetic.index_strings(build(fa, cfg))
    rng = np.random.default_rng(5)
    synthetic.write_reads(fq, synthetic.with_n(
        synthetic.cut_reads(strings, 60, 70, rng, rc=0.5, subst=0.01)
        + synthetic.random_reads(40, 70, rng), 0.05, rng))
    assert cli.main(["build", "-i", fa, "-k", "31", "-m", "13", "--weighted", "-o", saved]) == 0
    return fa, fq, saved


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def test_cli_build_prints_jax_info(fasta, capsys):
    fa = fasta[0]
    argv = ["build", "-i", fa, "-k", "31", "-m", "13", "--weighted"]
    assert _run(cli.main, argv, capsys) == _run(jcli.main, argv, capsys)
    argv += ["--canonical", "-s", "7"]
    assert _run(cli.main, argv, capsys) == _run(jcli.main, argv, capsys)


def test_cli_check_on_the_cpu(fasta, capsys):
    assert "check: OK" in _run(cli.main, ["check", "-i", fasta[2], "--device", "cpu"], capsys)


def test_cli_check_has_no_cpu_fallback(fasta):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises((AssertionError, RuntimeError)):
        cli.main(["check", "-i", fasta[2]])


def _query_lines(text):
    lines = text.strip().splitlines()
    rep = json.loads(lines[-1])
    rep.pop("elapsed_millisec")
    return lines[:-1], rep


def test_cli_query_equals_jax(fasta, capsys):
    _, fq, saved = fasta
    want = _query_lines(_run(jcli.main, ["query", "-i", saved, "-q", fq, "--host"], capsys))
    assert want[1]["num_positive_kmers"] > 0 and want[1]["num_negative_kmers"] > 0
    for flags in (["--device", "cpu"], ["--host"]):
        got = _query_lines(_run(cli.main, ["query", "-i", saved, "-q", fq] + flags, capsys))
        assert got == want, flags


def test_cli_bench_rows_equal_jax(fasta, capsys):
    argv = ["bench", "-i", fasta[2], "--batch", "2048", "--runs", "1"]
    want = json.loads(_run(jcli.main, argv + ["--host"], capsys))
    assert "positive_lookup_weight (avg_nanosec_per_kmer)" in want
    for flags in (["--device", "cpu"], ["--host"]):
        got = json.loads(_run(cli.main, argv + flags, capsys))
        assert list(got) == list(want) and got["batch"] == 2048, flags
        assert all(v > 0 for v in got.values())


def test_cli_permute_prints_jax_stats(fasta, tmp_path, capsys):
    fa = fasta[0]
    got = _run(cli.main, ["permute", "-i", fa, "-k", "31", "-o", str(tmp_path / "a.fa")], capsys)
    want = _run(jcli.main, ["permute", "-i", fa, "-k", "31", "-o", str(tmp_path / "b.fa")],
                capsys)
    assert got == want and json.loads(got)["final_runs"] > 0


# a sitecustomize for the spawned interpreters: JAX and the JAX package
# cannot be imported, and at exit the process records its argv, any of them
# loaded and whether it loaded torch. chip_smoke.py's PROBE adds the peak
# RSS; it is not imported from there, since importing chip_smoke.py blocks
# JAX in the importing process, and with it the tests that follow
PROBE = textwrap.dedent("""
    import atexit, importlib.abc, json, os, sys

    class _Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in %r:
                raise ImportError(f"{name} is blocked")

    sys.meta_path.insert(0, _Block())

    def _record():
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in %r)
        with open(os.path.join(%r, f"{os.getpid()}.json"), "w") as f:
            json.dump({"argv": sys.argv, "loaded": loaded, "torch": "torch" in sys.modules}, f)

    atexit.register(_record)
""")


def test_module_entry_runs_with_jax_blocked(fasta, tmp_path):
    """python -m sshash_tpu_torch build, check, query and permute on the CPU,
    in processes that can import neither JAX nor the JAX package (the
    2-process build's workers too), each ending with neither loaded; the
    host-only ones (build, its workers, permute) never load torch."""
    fa, fq, _ = fasta
    probe, records = tmp_path / "probe", tmp_path / "records"
    probe.mkdir()
    records.mkdir()
    (probe / "sitecustomize.py").write_text(PROBE % (BLOCKED, BLOCKED, str(records)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(probe), REPO]))
    saved = str(tmp_path / "w.idx")
    runs = [["build", "-i", fa, "-k", "31", "-m", "13", "--weighted", "--scan-procs", "2",
             "-g", "16", "-d", str(tmp_path), "-o", saved],
            ["check", "-i", saved, "--device", "cpu"],
            ["query", "-i", saved, "-q", fq, "--device", "cpu"],
            ["permute", "-i", fa, "-k", "31", "-o", str(tmp_path / "p.fa")]]
    for argv in runs:
        out = subprocess.run([sys.executable, "-m", "sshash_tpu_torch"] + argv, env=env,
                             cwd=tmp_path, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        assert argv[0] != "check" or "check: OK" in out.stdout
    recs = [json.loads(p.read_text()) for p in records.iterdir()]
    assert all(r["loaded"] == [] for r in recs)
    mains = [r for r in recs if r["argv"][0].endswith(os.path.join("sshash_tpu_torch",
                                                                   "__main__.py"))]
    workers = [r for r in recs if r["argv"][0].endswith(
        os.path.join("sshash_tpu_torch", "builder", "distributed.py"))]
    assert len(mains) == 4 and len(workers) == 2 and len(recs) == 6
    assert sorted(w["argv"][w["argv"].index("--wid") + 1] for w in workers) == ["0", "1"]
    for r in recs:
        assert r["torch"] == any(cmd in r["argv"] for cmd in ("check", "query")), r["argv"]
