"""Several processes on one mesh: torch.distributed bootstrap and per-row
data feeding (the counterpart of sshash_tpu/parallel/multihost.py).

A DistMesh of shape (D, NB) runs one shard per rank; rank r answers data
row r // NB from bucket column r % NB's tables. Nothing on a machine tells
a program of its cluster, so the address, world size and rank are given:

    from sshash_tpu_torch.parallel import multihost, ShardedEngine
    multihost.initialize("localhost:29500", world_size=4, rank=r)
    mesh = multihost.global_mesh(bucket=2)        # (2, 2)
    eng = ShardedEngine(index, mesh)
    local = multihost.host_local_batch(kmers32_global, mesh)
    res, report = eng.lookup_device(multihost.make_global_batch(local, mesh,
                                                                kmers32_global.shape))
    # or eng.lookup_multiprocess(kmers64) with the global batch

The bucket ranks of a data row answer the same lanes, so they are fed the
same rows. Each rank runs its shard on cuda:<rank mod cards> (DistMesh's
default; device="cpu" for the plain versions). NCCL combines between
cards; ranks that share one card initialise the group with
backend="gloo", which stages each combine through host memory. Build the
kernel library (kernels.library()) in the parent before starting the
ranks, so that they load it instead of each running nvcc.
"""

import numpy as np
import torch


def initialize(address=None, world_size=None, rank=None, backend="nccl"):
    """torch.distributed.init_process_group over tcp://address; a no-op
    (False) without an address and a world of more than one, or when a
    group exists already. backend: NCCL between cards by default (it raises
    without CUDA); "gloo" for ranks that share a card, or for CPU ranks.
    Either way the mesh's device, not the backend, picks where the shards
    run (DistMesh)."""
    import torch.distributed as dist

    if dist.is_initialized() or (address is None and world_size in (None, 1)):
        return False
    if address is None or world_size is None or rank is None:
        raise ValueError("initialize needs the address, the world size and the rank")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("initialize: NCCL needs CUDA, and no card is visible; pass "
                           "backend='gloo' to run the shards on the CPU")
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world_size,
                            rank=rank)
    return True


def global_mesh(bucket=None, device=None):
    """DistMesh over every rank: bucket columns (2 where the world size is
    even, else 1), the rest data rows; device as DistMesh's (a card unless
    "cpu" is given)."""
    import torch.distributed as dist

    from .mesh import DistMesh

    n = dist.get_world_size()
    if bucket is None:
        bucket = 2 if n % 2 == 0 else 1
    if n % bucket:
        raise ValueError(f"{n} ranks do not divide into bucket={bucket}")
    return DistMesh((n // bucket, bucket), device)


def local_row_range(mesh, n):
    """[lo, hi): the lanes of a length-n batch (a multiple of the data-axis
    size) that this process's data rows answer."""
    D = mesh.shape[0]
    if n % D:
        raise ValueError(f"a batch of {n} does not split over {D} data rows")
    rows = mesh.rows
    if rows != list(range(rows[0], rows[-1] + 1)):
        raise ValueError(f"this process's data rows {rows} are not contiguous")
    return rows[0] * (n // D), (rows[-1] + 1) * (n // D)


def host_local_batch(global_array, mesh):
    """This process's rows of a batch every process holds (a NumPy array or
    a tensor on any device; a slice of it, where it lies)."""
    lo, hi = local_row_range(mesh, len(global_array))
    return global_array[lo:hi]


def make_global_batch(local_rows, mesh, global_shape):
    """This process's part of a global batch, as the engine's device entry
    points take it: a contiguous tensor of its rows on the mesh's device
    (the rows stay where they are: the mesh has no global array).
    local_rows: a NumPy array (uint32 rows as their int32 bits) or a
    tensor on any device."""
    lo, hi = local_row_range(mesh, global_shape[0])
    if not isinstance(local_rows, torch.Tensor):
        local_rows = np.asarray(local_rows)
        if local_rows.dtype == np.uint32:
            local_rows = local_rows.view(np.int32)
        local_rows = torch.from_numpy(np.ascontiguousarray(local_rows))
    if tuple(local_rows.shape) != (hi - lo,) + tuple(global_shape[1:]):
        raise ValueError(f"rows of shape {tuple(local_rows.shape)} are not rows [{lo}, {hi}) "
                         f"of a batch of {tuple(global_shape)}")
    return local_rows.to(mesh.device).contiguous()
