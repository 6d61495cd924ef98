"""The port's out-of-core and multi-process builders against its in-memory
build and the JAX package's out-of-core build: the same FASTA gives
array-equal indexes (every array and format field, build stats aside).

The ranged builds always make a partitioned minimizer MPHF (P = the
partition count of avg_partition_size, at most R_RANGES), while the
in-memory build partitions only past avg_partition_size, so every build
here forces avg_partition_size below the minimizer count."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import sshash_tpu
from sshash_tpu_torch import BuildConfig, build, native, oracle, synthetic
from sshash_tpu_torch.builder import distributed
from sshash_tpu_torch.mphf import PartitionedMPHF
from test_torch_host import assert_same_index
from one_thread import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(not native.available(), reason="needs the native scanner")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 1 << 15

# name -> (write_input parameters, avg_partition_size)
CASES = {
    "m13_regular": (synthetic.SMALL_CONFIGS["m13_regular"], 2_000),
    "m15_canonical": (dict(synthetic.SMALL_CONFIGS["m13_canonical"], m=15), 1_000),
    "weighted": (dict(synthetic.SMALL_CONFIGS["weighted"], num_strings=256), 256),
    # heavy buckets: the ranged assembly's skew classes
    "m3_skew": (synthetic.SMALL_CONFIGS["m3_skew"], 8),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    """(name, FASTA path, BuildConfig with avg_partition_size forced, the
    port's in-memory Index)."""
    params, avg = CASES[request.param]
    path = str(tmp_path_factory.mktemp(request.param) / "unitigs.fa")
    cfg = dataclasses.replace(synthetic.write_input(path, **params), avg_partition_size=avg)
    ram = build(path, cfg)
    assert isinstance(ram.minimizer_mphf, PartitionedMPHF)
    assert 1 < ram.minimizer_mphf.num_partitions <= 1024
    return request.param, path, cfg, ram


def test_external_build_equals_in_memory_and_jax(case, tmp_path):
    name, path, cfg, ram = case
    ext = build(path, dataclasses.replace(cfg, ram_limit_mb=1, tmp_dir=str(tmp_path)))
    assert_same_index(ext, ram)
    for key in ("num_minimizers", "max_bucket_size", "num_super_kmers"):
        assert ext.stats[key] == ram.stats[key], key
    # one scan buffer: the router flushes once, at the scan's end
    assert ext.stats["spill_flushes"] == 1
    jcfg = sshash_tpu.BuildConfig(**dict(dataclasses.asdict(cfg), ram_limit_mb=1,
                                         tmp_dir=str(tmp_path)))
    assert_same_index(ext, sshash_tpu.Dictionary.build(path, jcfg).index)
    # the spill directory is removed after the build
    assert os.listdir(tmp_path) == []
    ids = np.arange(0, ext.num_kmers, 3)
    assert np.array_equal(oracle.lookup(ext, oracle.access(ext, ids))["kmer_id"],
                          ids.astype(np.uint64))


def test_budget_spills_during_the_scan(tmp_path):
    """Past the scan buffer's 2^20 chars, a budget of 1 MB makes the router
    flush while the scan runs. The arrays equal the in-memory build's and
    JAX's out-of-core build's, whose one scan buffer flushes once."""
    path = str(tmp_path / "unitigs.fa")
    params = dict(synthetic.SMALL_CONFIGS["m13_regular"], num_strings=1200)
    cfg = dataclasses.replace(synthetic.write_input(path, **params), avg_partition_size=20_000)
    ext = build(path, dataclasses.replace(cfg, ram_limit_mb=1, tmp_dir=str(tmp_path)))
    assert ext.num_kmers > 1 << 20 and ext.stats["spill_flushes"] >= 2
    assert_same_index(ext, build(path, cfg))
    jcfg = sshash_tpu.BuildConfig(**dict(dataclasses.asdict(cfg), ram_limit_mb=1,
                                         tmp_dir=str(tmp_path)))
    assert_same_index(ext, sshash_tpu.Dictionary.build(path, jcfg).index)


def _ranged(path, cfg, nprocs, **kw):
    """build_distributed with blocks of BLOCK chars, so that both ranks
    scan part of a small input."""
    return distributed.build_distributed(path, cfg, {}, lambda name, fn: fn(), nprocs,
                                         block_chars=BLOCK, **kw)


@pytest.mark.parametrize("name", ["m13_regular", "m15_canonical"])
def test_two_process_build_equals_in_memory(name, tmp_path):
    params, avg = CASES[name]
    path = str(tmp_path / "unitigs.fa")
    cfg = dataclasses.replace(synthetic.write_input(path, **params), avg_partition_size=avg)
    dist = _ranged(path, dataclasses.replace(cfg, ram_limit_mb=8, tmp_dir=str(tmp_path)), 2)
    ram = build(path, cfg)
    assert_same_index(dist, ram)
    assert dist.stats["num_minimizers"] == ram.stats["num_minimizers"]
    # through build() too, at the default block size (one rank's blocks)
    assert_same_index(build(path, dataclasses.replace(cfg, scan_procs=2)), ram)


def test_worker_argv_names_the_port():
    argv = distributed._worker_argv("in.fa", 31, 13, 1, True, 0, 2, "spill", 1 << 20, 1 << 22)
    assert argv[:3] == [sys.executable, "-m", "sshash_tpu_torch.builder.distributed"]
    assert argv[-1] == "--canonical" and argv[argv.index("--wid") + 1] == "0"


def test_assemble_from_ranks_spilled_by_hand(tmp_path):
    """Worker ranks run the worker CLI into a shared directory; the
    assembly from it (scan_dir) equals the in-memory build, and a rank's
    meta file that disagrees is refused."""
    params, avg = CASES["m13_regular"]
    path = str(tmp_path / "unitigs.fa")
    cfg = dataclasses.replace(synthetic.write_input(path, **params), avg_partition_size=avg)
    spill = tmp_path / "spill"
    spill.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for w in range(2):
        subprocess.run([sys.executable, "-m", "sshash_tpu_torch.builder.distributed",
                        "--input", path, "-k", str(cfg.k), "-m", str(cfg.m),
                        "--seed", str(cfg.seed), "--wid", str(w), "--nworkers", "2",
                        "--dir", str(spill), "--block-chars", str(BLOCK)],
                       check=True, env=env)
    assert sorted(p for p in os.listdir(spill) if p.startswith("meta")) == [
        "meta_w0.json", "meta_w1.json"]
    for w in range(2):
        assert json.loads((spill / f"meta_w{w}.json").read_text())["tuples"] > 0
    ram = build(path, cfg)
    assert_same_index(_ranged(path, dataclasses.replace(cfg, scan_dir=str(spill)), 2), ram)
    # the operator's directory stays
    assert (spill / "meta_w0.json").exists()
    with pytest.raises(RuntimeError, match="different parameters"):
        # build() assembles at the default block size, not the ranks'
        build(path, dataclasses.replace(cfg, scan_procs=2, scan_dir=str(spill)))
    with pytest.raises(RuntimeError, match="nworkers"):
        _ranged(path, dataclasses.replace(cfg, scan_dir=str(spill)), 3)


def test_validate_refuses_no_scan_process():
    with pytest.raises(ValueError, match="scan_procs"):
        BuildConfig(k=31, m=13, scan_procs=0).validate()
