"""The bucket-sharded engine over real processes: two or four CPU processes
join a gloo torch.distributed group, each runs one shard of a DistMesh
(device="cpu"), and each holds its lookup, access, weight, navigation,
stream report and packed stream to a LocalMesh of the same shape in its
own process; with four processes the parent also saves the JAX
ShardedEngine's lookup and stream report on a CPU mesh of the same shape,
and each process holds its rows to them. Run as a script, this file is one
such process:

    python tests/test_torch_multihost.py <rank> <world> <port> <D> <NB> <dir>

It imports neither JAX nor the JAX package (the parent tests import JAX
inside their bodies only). Tolerance 0."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
from one_thread import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# the indexes every process runs; m3_skew's skew classes carry hindex, so
# its heavy lanes' rows are handed between the bucket ranks
NAMES = ("weighted", "m3_skew")
JAX_NAMES = ("m3_skew",)  # the index held to JAX's ShardedEngine with 4 processes
LOOKUP_KEYS = ("kmer_id", "kmer_id_in_string", "kmer_offset", "kmer_orientation", "string_id",
               "string_begin", "string_end", "minimizer_found")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _inputs(idx, seed):
    """The batches every process and the parent draw for one index: a lookup
    batch (50%-RC positives, then random kmers; an odd length, so it pads
    to the data axis) and a per-position stream of 4 reads of 150
    (ids, valid, first)."""
    from sshash_tpu_torch import kmer as K
    from sshash_tpu_torch import oracle, synthetic

    rng = np.random.default_rng(seed)
    km = oracle.access(idx, rng.integers(0, idx.num_kmers, 300))
    km[::2] = K.revcomp_kmers(km[::2], idx.k)
    q = np.concatenate([km, synthetic.random_kmers(idx.k, rng, 101)])
    sids = np.concatenate([np.arange(s, s + 150)
                           for s in rng.integers(0, idx.num_kmers - 150, 4)])
    first = np.zeros(len(sids), dtype=bool)
    first[::150] = True
    valid = rng.random(len(sids)) > 0.02
    return q, oracle.access(idx, sids), valid, first


def _run(world, shape, tmp_path, timeout=120, device="cpu"):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), str(port),
                               *map(str, shape), str(tmp_path), device],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        assert f"MULTIHOST_OK {r}" in out, out[-4000:]
    # the hindex index's heavy lanes whose rows another rank holds: with two
    # or more bucket ranks the hand-off runs between processes
    moved = [int(ln.split()[3]) for out in outs for ln in out.splitlines()
             if ln.startswith("HANDOFF ")]
    assert len(moved) == world * (device == "cpu"), outs[0][-4000:]
    assert device != "cpu" or shape[1] == 1 or sum(moved) > 0, moved
    return outs


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_two_processes_equal_a_local_mesh(shape, tmp_path):
    _run(2, shape, tmp_path)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_four_processes_equal_jax_and_a_local_mesh(shape, tmp_path):
    """Four processes, the planted-skew hindex index among the indexes (its
    hand-off runs between bucket ranks): each rank's lookup rows and the
    stream report also equal the JAX ShardedEngine's on a CPU mesh of the
    same shape."""
    from sshash_tpu_torch import synthetic
    from test_torch_host import jax_index
    from test_torch_sharded import JaxShardedEngine, jax_mesh

    for name in JAX_NAMES:
        idx = synthetic.small_index(name)
        q, skm, valid, first = _inputs(idx, NAMES.index(name))
        jeng = JaxShardedEngine(jax_index(idx), jax_mesh(shape))
        res, rep = jeng.lookup(q)
        for key in LOOKUP_KEYS:
            np.save(tmp_path / f"jax_{name}_{key}.npy", np.asarray(res[key]))
        srep = jeng.stream_report(skm, valid, first)
        np.save(tmp_path / f"jax_{name}_report.npy",
                np.array([rep["num_kmers"], rep["num_positive"]]))
        np.save(tmp_path / f"jax_{name}_stream.npy",
                np.array([srep[key] for key in sorted(srep)]))
    outs = _run(4, shape, tmp_path)
    for r, out in enumerate(outs):
        assert f"JAX_HELD {r} {' '.join(JAX_NAMES)}" in out, out[-4000:]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ranks run the kernels, which have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_two_gloo_ranks_share_a_card(card, tmp_path):
    """Two gloo ranks on cuda:0 at (1, 2), each with its own column's tables
    on the card (DistMesh's default device): every rank's lookup rows and
    the report equal a LocalMesh of the same shape on the card."""
    outs = _run(2, (1, 2), tmp_path, device="cuda")
    assert all("on cuda:0" in out for out in outs), outs[0][-4000:]


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


def test_dist_mesh_without_a_card_or_a_device_raises(monkeypatch):
    """DistMesh runs on a card unless it is given device="cpu": with no card
    visible and no device named it raises, under gloo too; "cpu" works."""
    import torch
    import torch.distributed as dist

    from sshash_tpu_torch.parallel import DistMesh, multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    multihost.initialize(f"localhost:{_free_port()}", 1, 0, backend="gloo")
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DistMesh((1, 1))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            multihost.global_mesh()
        assert DistMesh((1, 1), device="cpu").device == torch.device("cpu")
        assert multihost.global_mesh(device="cpu").shape == (1, 1)
    finally:
        dist.destroy_process_group()


def test_shared_device_check():
    """Under NCCL a DistMesh gathers each rank's (host, card) and raises
    where two ranks share a card; shared_devices is that check, a pure
    function of the gathered list."""
    from sshash_tpu_torch.parallel.mesh import shared_devices

    assert shared_devices([("a", 0), ("a", 1), ("b", 0), ("b", 1)]) == {}
    assert shared_devices([("a", 0)] * 4) == {("a", 0): [0, 1, 2, 3]}
    assert shared_devices([("a", 0), ("b", 0), ("a", 0), None, None]) == {("a", 0): [0, 2]}
    assert shared_devices([["h", 3], ["h", 3]]) == {("h", 3): [0, 1]}  # as gathered objects
    assert shared_devices([None, None]) == {}


def test_batch_helpers_take_tensors():
    """host_local_batch and make_global_batch take NumPy arrays and tensors
    alike (a tensor's rows move to the mesh's device)."""
    import torch

    from sshash_tpu_torch.parallel import LocalMesh, multihost

    mesh = LocalMesh((2, 1), "cpu")
    mesh.local = [(1, 0)]  # data row 1 of 2, as a DistMesh rank holds it
    rows = np.arange(24, dtype=np.uint32).reshape(8, 3)
    local = multihost.host_local_batch(rows, mesh)
    assert np.array_equal(local, rows[4:])
    got = multihost.make_global_batch(local, mesh, rows.shape)
    assert got.dtype == torch.int32 and torch.equal(got, torch.from_numpy(rows[4:].view(np.int32)))
    t = torch.from_numpy(rows.view(np.int32))
    tl = multihost.host_local_batch(t, mesh)
    assert torch.equal(multihost.make_global_batch(tl, mesh, tuple(t.shape)), got)
    with pytest.raises(ValueError, match="are not rows"):
        multihost.make_global_batch(t[:3], mesh, tuple(t.shape))


def _worker(rank, world, port, shape, tmp):
    import torch
    import torch.distributed as dist

    from sshash_tpu_torch import synthetic
    from sshash_tpu_torch import kmer as K
    from sshash_tpu_torch import streaming as ST
    from sshash_tpu_torch.parallel import (DistMesh, LocalMesh, ShardedEngine, ShardedStream,
                                           multihost)

    torch.set_num_threads(1)
    assert multihost.initialize(f"localhost:{port}", world, rank, backend="gloo")
    mesh = DistMesh(shape, device="cpu")
    assert mesh.local == [(rank // shape[1], rank % shape[1])]
    assert mesh.device.type == "cpu"
    held = []
    for name in NAMES:
        idx = synthetic.small_index(name)
        eng = ShardedEngine(idx, mesh)
        ref = ShardedEngine(idx, LocalMesh(shape, "cpu"))
        assert eng.per_device_bytes() == ref.per_device_bytes()
        assert list(eng.table_bytes()) == [mesh.local[0][1]]  # its own column only
        q, kms, valid, first = _inputs(idx, NAMES.index(name))
        lo, hi = multihost.local_row_range(mesh, len(q) + len(q) % 2)
        want, want_rep = ref.lookup(q)
        seen = []
        mesh.pmin = _handed_on(mesh, eng.probe_shards[mesh.local[0][1]], seen)
        got, rep = eng.lookup(q)
        del mesh.pmin
        if eng.handoff:
            print(f"HANDOFF {rank} {name} {sum(seen)}", flush=True)
        assert rep == want_rep, (rep, want_rep)
        for key in want:
            assert np.array_equal(got[key], want[key][lo:hi]), key
        srep = eng.stream_report(kms, valid, first)
        assert srep == ref.stream_report(kms, valid, first)
        if os.path.exists(os.path.join(tmp, f"jax_{name}_report.npy")):
            jax_at = lambda what: np.load(os.path.join(tmp, f"jax_{name}_{what}.npy"))  # noqa
            for key in LOOKUP_KEYS:
                assert np.array_equal(got[key], jax_at(key)[lo:hi]), key
            assert [rep["num_kmers"], rep["num_positive"]] == jax_at("report").tolist()
            assert [srep[key] for key in sorted(srep)] == jax_at("stream").tolist()
            held.append(name)
        even = q[: len(q) - len(q) % 2]
        res, rep, (lo2, hi2) = eng.lookup_multiprocess(even)
        assert (lo2, hi2) == multihost.local_row_range(mesh, len(even))
        assert np.array_equal(res["kmer_id"], ref.lookup(even)[0]["kmer_id"][lo2:hi2])
        assert np.array_equal(eng.is_member(q), ref.is_member(q)[lo:hi])
        ids = np.arange(idx.num_kmers - 1)
        lo, hi = multihost.local_row_range(mesh, len(ids) + len(ids) % 2)
        assert np.array_equal(eng.access(ids), ref.access(ids)[lo:hi])
        if idx.weights is not None:
            assert np.array_equal(eng.weight(ids), ref.weight(ids)[lo:hi])
        nb_got, nb_want = eng.kmer_neighbours(q[:64]), ref.kmer_neighbours(q[:64])
        lo, hi = multihost.local_row_range(mesh, 64)
        for key in nb_want:
            assert np.array_equal(nb_got[key], nb_want[key][lo:hi]), key
        local = multihost.host_local_batch(K.kmers_to_u32(kms, idx.k), mesh)
        assert tuple(multihost.make_global_batch(local, mesh, (len(kms), eng.cfg.W)).shape) == \
            local.shape
    print(f"JAX_HELD {rank} {' '.join(held)}", flush=True)
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


def _handed_on(mesh, shard, seen):
    """Wrap mesh.pmin so that the hand-off's combine (the one unsigned pmin
    over the bucket axis in a lookup) appends to seen the lanes whose heavy
    row this rank found and another rank holds: their rows went between
    processes."""
    import torch

    pmin = mesh.pmin

    def counted(values, axis, unsigned=False):
        if unsigned and axis == "bucket":
            (v,) = values.values()
            h = v.to(torch.int64) & 0xFFFFFFFF
            seen.append(int(((h != 0xFFFFFFFF) & ((h < shard.hrow_lo)
                                                  | (h >= shard.hrow_hi))).sum()))
        return pmin(values, axis, unsigned)

    return counted


def _card_worker(rank, world, port, shape, tmp):
    """A rank on the card: gloo between ranks sharing it, DistMesh's
    default device (cuda:<rank mod cards>), its column's tables uploaded,
    the lookup's rows and report equal to a LocalMesh on the card."""
    import torch

    from sshash_tpu_torch import synthetic
    from sshash_tpu_torch.parallel import LocalMesh, ShardedEngine, multihost

    assert multihost.initialize(f"localhost:{port}", world, rank, backend="gloo")
    mesh = multihost.global_mesh(bucket=shape[1])
    assert mesh.shape == shape and mesh.device.type == "cuda"
    for name in ("m13_regular", "m3_skew"):
        idx = synthetic.small_index(name)
        eng = ShardedEngine(idx, mesh)
        ref = ShardedEngine(idx, LocalMesh(shape, mesh.device))
        assert list(eng.table_bytes()) == [mesh.local[0][1]]
        q, _, _, _ = _inputs(idx, 0)
        lo, hi = multihost.local_row_range(mesh, len(q) + len(q) % 2)
        got, rep = eng.lookup(q)
        want, want_rep = ref.lookup(q)
        assert rep == want_rep, (rep, want_rep)
        for key in want:
            assert np.array_equal(got[key], want[key][lo:hi]), key
    torch.distributed.destroy_process_group()
    print(f"MULTIHOST_OK {rank} on {mesh.device}", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    r, w, p, d, nb, tmp, device = sys.argv[1:8]
    (_worker if device == "cpu" else _card_worker)(int(r), int(w), int(p), (int(d), int(nb)),
                                                   tmp)
