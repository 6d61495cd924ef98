"""The bucket-sharded engine over real processes: two CPU processes join a
gloo torch.distributed group, each runs one shard of a DistMesh, and each
holds its lookup, access, weight, navigation, stream report and packed
stream to a LocalMesh of the same shape in its own process. Run as a
script, this file is one such process:

    python tests/test_torch_multihost.py <rank> <world> <port> <D> <NB>

It imports neither JAX nor the JAX package."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_two_processes_equal_a_local_mesh(shape, tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "2", str(port), *map(str, shape),
                               str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        assert f"MULTIHOST_OK {r}" in out, out[-4000:]


def test_initialize_defaults_to_nccl_and_raises_without_a_card(monkeypatch):
    """A group started without naming a backend is NCCL: without CUDA it
    raises instead of running the shards' plain versions on the CPU."""
    import torch
    import torch.distributed as dist

    from sshash_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL needs CUDA"):
        multihost.initialize(f"localhost:{_free_port()}", 2, 0)
    assert not dist.is_initialized()


def _worker(rank, world, port, shape, tmp):
    import torch
    import torch.distributed as dist

    from sshash_tpu_torch import oracle, synthetic
    from sshash_tpu_torch import kmer as K
    from sshash_tpu_torch import streaming as ST
    from sshash_tpu_torch.parallel import (DistMesh, LocalMesh, ShardedEngine, ShardedStream,
                                           multihost)

    torch.set_num_threads(1)
    assert multihost.initialize(f"localhost:{port}", world, rank, backend="gloo")
    mesh = DistMesh(shape)
    assert mesh.local == [(rank // shape[1], rank % shape[1])]
    assert mesh.device.type == "cpu"
    rng = np.random.default_rng(0)  # the same batch in every process
    for name in ("weighted", "m3_skew"):
        idx = synthetic.small_index(name)
        eng = ShardedEngine(idx, mesh)
        ref = ShardedEngine(idx, LocalMesh(shape, "cpu"))
        km = oracle.access(idx, rng.integers(0, idx.num_kmers, 300))
        km[::2] = K.revcomp_kmers(km[::2], idx.k)
        q = np.concatenate([km, synthetic.random_kmers(idx.k, rng, 101)])
        lo, hi = multihost.local_row_range(mesh, len(q) + len(q) % 2)
        want, want_rep = ref.lookup(q)
        got, rep = eng.lookup(q)
        assert rep == want_rep, (rep, want_rep)
        for key in want:
            assert np.array_equal(got[key], want[key][lo:hi]), key
        even = q[: len(q) - len(q) % 2]
        res, rep, (lo2, hi2) = eng.lookup_multiprocess(even)
        assert (lo2, hi2) == multihost.local_row_range(mesh, len(even))
        assert np.array_equal(res["kmer_id"], ref.lookup(even)[0]["kmer_id"][lo2:hi2])
        ids = np.arange(idx.num_kmers - 1)
        lo, hi = multihost.local_row_range(mesh, len(ids) + len(ids) % 2)
        assert np.array_equal(eng.access(ids), ref.access(ids)[lo:hi])
        if idx.weights is not None:
            assert np.array_equal(eng.weight(ids), ref.weight(ids)[lo:hi])
        nb_got, nb_want = eng.kmer_neighbours(q[:64]), ref.kmer_neighbours(q[:64])
        lo, hi = multihost.local_row_range(mesh, 64)
        for key in nb_want:
            assert np.array_equal(nb_got[key], nb_want[key][lo:hi]), key
        # per-position stream: 4 reads of 150 positions straddle the rows
        ids = np.concatenate([np.arange(s, s + 150) for s in rng.integers(0, idx.num_kmers - 150,
                                                                          4)])
        first = np.zeros(len(ids), dtype=bool)
        first[::150] = True
        valid = rng.random(len(ids)) > 0.02
        kms = oracle.access(idx, ids)
        assert eng.stream_report(kms, valid, first) == ref.stream_report(kms, valid, first)
        local = multihost.host_local_batch(K.kmers_to_u32(kms, idx.k), mesh)
        assert tuple(multihost.make_global_batch(local, mesh, (len(kms), eng.cfg.W)).shape) == \
            local.shape
    # the packed stream: each data row streams its own reads (the bucket
    # ranks of a row the same ones); the summed report equals a LocalMesh
    # streaming every row's reads
    idx = synthetic.small_index("m13_canonical")
    strings = synthetic.index_strings(idx)
    paths = []
    for row in range(shape[0]):
        r = np.random.default_rng(10 + row)
        paths.append(os.path.join(tmp, f"reads{row}.fq"))
        if rank == 0:
            synthetic.write_reads(paths[-1], synthetic.cut_reads(strings, 60, 120, r, rc=0.5)
                                  + synthetic.random_reads(20, 76, r))
    dist.barrier()
    eng = ShardedEngine(idx, mesh)
    s = ShardedStream(eng, pmax=1 << 11)
    for seq in ST.parse_reads(paths[mesh.rows[0]]):
        s.add_read(seq)
    rep = s.finalize()
    ref = ShardedStream(ShardedEngine(idx, LocalMesh(shape, "cpu")), pmax=1 << 11)
    for path in paths:
        for seq in ST.parse_reads(path):
            ref.add_read(seq)
    assert rep == ref.finalize(), rep
    dist.destroy_process_group()
    print(f"MULTIHOST_OK {rank}", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    r, w, p, d, nb, tmp = sys.argv[1:7]
    _worker(int(r), int(w), int(p), (int(d), int(nb)), tmp)
