"""The mesh of the bucket-sharded engine, and its combines.

Counterpart of jax.sharding.Mesh and of the collectives shard_map's bodies
call in sshash_tpu/parallel/sharded.py. A mesh of shape (D, NB) has a
`data` axis of D rows, each answering its slice of the query batch, and a
`bucket` axis of NB columns, each holding one slice of the index: shard
(i, j) answers row i's lanes from column j's tables. Per-shard values are
dicts {(i, j): tensor} over the shards this process holds (`local`); a
combine over one axis reduces the values of each group of shards that
differ only along that axis, and every shard of the group gets the result:

  pmin / pmax(values, axis, unsigned=False)   elementwise min / max; with
      unsigned=True the int32 tensors hold u32 bits and order as u32 (the
      top bit flips around a signed reduction: 0xFFFFFFFF, -1 as an
      int32, is the largest value, not the smallest)
  psum(values, axis)                          elementwise sum
  ppermute(values)                            data row i gets row i-1's
      value, row 0 zeros

Two implementations:

  LocalMesh(shape, device)  every shard in this process, on one device; a
      combine of a group of two or more is one launch of the combine
      kernel (csrc/combine.cu: one pass over the group's tensors, 16-byte
      loads, the u32 order in the kernel), whose plain version
      (combine_plain, what the CPU runs) stacks them and reduces. The
      bucket-sharded lookup has no combine here: kernel 2's shard form
      stores each lane once, from the shard that owns it (sharded.py).
  DistMesh(shape, device)   one shard per rank of a torch.distributed group
      (rank r is shard (r // NB, r % NB)), a sub-group per data row and per
      bucket column; a combine is one all_reduce (MIN, MAX, SUM) on the
      sub-group, ppermute an all_gather of the column (its payloads are a
      few words, and every backend has all_gather on every device). The
      rank's tensors live on cuda:<rank mod cards> unless the caller
      passes a device ("cpu" runs the plain versions). NCCL combines
      between cards; gloo takes card tensors too, staging each combine
      through host memory, so ranks that share one card run over gloo
      (NCCL refuses two ranks of a communicator on one device, and
      DistMesh raises before it does). A world of one rank runs the same
      calls.
"""

import socket

import torch

from .. import kernels

AXES = ("data", "bucket")
_TOP = -(1 << 31)  # the int32 with only the top bit set


def _flip(t):
    """u32 bits in int32 <-> an int32 of the same unsigned order."""
    return t ^ _TOP


def combine_plain(op, unsigned, *ts):
    """Plain version of the combine kernel (csrc/combine.cu): the
    elementwise min, max or sum (op) of the tensors ts (one shape and
    dtype), min and max ordered as unsigned with unsigned=True (u32 bits in
    int32), sums in the tensors' dtype (wrapping): a stack and a
    reduction."""
    x = torch.stack([_flip(t) for t in ts] if unsigned else list(ts))
    r = x.amin(0) if op == "min" else x.amax(0) if op == "max" else x.sum(0, dtype=x.dtype)
    return _flip(r) if unsigned else r


combine = kernels.by_device(kernels.combine_kernel, combine_plain, "combine", arg=2)


class _Mesh:
    axis_names = AXES

    def __init__(self, shape, device):
        D, NB = (int(x) for x in shape)
        if D < 1 or NB < 1:
            raise ValueError(f"mesh shape must be positive, got {shape}")
        self.shape = (D, NB)
        self.device = torch.device(device)

    @property
    def columns(self):
        """The bucket columns whose tables this process holds."""
        return sorted({j for _, j in self.local})

    @property
    def rows(self):
        """The data rows this process answers."""
        return sorted({i for i, _ in self.local})

    @property
    def row_shards(self):
        """One local shard per local row: the keys of a row-level value
        (the same on every shard of its row)."""
        first = {}
        for s in self.local:
            first.setdefault(s[0], s)
        return [first[i] for i in sorted(first)]

    def _axis(self, axis):
        if axis not in AXES:
            raise ValueError(f"axis must be one of {AXES}, got {axis!r}")
        return AXES.index(axis)

    def pmin(self, values, axis, unsigned=False):
        return self._reduce(values, self._axis(axis), "min", unsigned)

    def pmax(self, values, axis, unsigned=False):
        return self._reduce(values, self._axis(axis), "max", unsigned)

    def psum(self, values, axis):
        return self._reduce(values, self._axis(axis), "sum", False)


class LocalMesh(_Mesh):
    """Every shard of a (D, NB) mesh in this process, on one device."""

    def __init__(self, shape, device="cuda"):
        super().__init__(shape, device)
        D, NB = self.shape
        self.local = [(i, j) for i in range(D) for j in range(NB)]

    def _reduce(self, values, ax, op, unsigned):
        groups = {}
        for s in values:
            groups.setdefault(s[1 - ax], []).append(s)
        out = {}
        for members in groups.values():
            ts = [values[s] for s in members]
            r = ts[0] if len(ts) == 1 else combine(op, unsigned, *ts)
            for s in members:
                out[s] = r
        return out

    def ppermute(self, values):
        return {(i, j): values[(i - 1, j)] if i > 0 else torch.zeros_like(v)
                for (i, j), v in values.items()}


def shared_devices(places):
    """The ranks that share a card with another rank: places[r] is rank r's
    (host name, card index), None for a rank off the cards. Returns
    {(host, card): [ranks]} for each card that two or more ranks hold."""
    held = {}
    for r, place in enumerate(places):
        if place is not None:
            held.setdefault(tuple(place), []).append(r)
    return {place: ranks for place, ranks in held.items() if len(ranks) > 1}


def default_device(rank):
    """A rank's card when the caller names none: cuda:<rank mod cards>. With
    no card visible it raises: the plain versions run only where the
    caller asks for the CPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("DistMesh: no CUDA card is visible; pass device='cpu' to run the "
                           "shards' plain versions on the CPU")
    return torch.device("cuda", rank % n)


class DistMesh(_Mesh):
    """One shard of a (D, NB) mesh per rank of the default torch.distributed
    group (initialised by the caller, e.g. multihost.initialize), whose
    world size must be D * NB. device: the rank's tensors' device; by
    default cuda:<rank mod cards> under either backend (default_device),
    "cpu" for the plain versions. A card becomes the process's current
    device. Under NCCL the ranks first exchange their (host, card) over a
    gloo side group and raise if two share a card: NCCL would fail on it
    at the first collective."""

    def __init__(self, shape, device=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs an initialised torch.distributed group")
        self._dist = dist
        rank, world = dist.get_rank(), dist.get_world_size()
        D, NB = (int(x) for x in shape)
        if D * NB != world:
            raise ValueError(f"mesh {shape} needs {D * NB} ranks, the group has {world}")
        super().__init__(shape, default_device(rank) if device is None else device)
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(self.device)
        if dist.get_backend() == "nccl":
            places = [None] * world
            place = (socket.gethostname(), self.device.index) if self.device.type == "cuda" \
                else None
            dist.all_gather_object(places, place, group=dist.new_group(backend="gloo"))
            shared = shared_devices(places)
            if shared:
                raise RuntimeError(f"DistMesh: NCCL cannot put two ranks of one group on one "
                                   f"card, and ranks share cards {shared}; initialise the group "
                                   f"with backend='gloo' to run them on a shared card")
        self.local = [(rank // NB, rank % NB)]
        # every rank creates every group, in the same order
        rows = [dist.new_group([i * NB + j for j in range(NB)]) for i in range(D)]
        cols = [dist.new_group([i * NB + j for i in range(D)]) for j in range(NB)]
        i, j = self.local[0]
        # a combine over the bucket axis runs within a data row, and the
        # reverse
        self._groups = (cols[j], rows[i])

    def _reduce(self, values, ax, op, unsigned):
        (s, v), = values.items()
        dist = self._dist
        red = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}[op]
        t = v.to(torch.int32) if v.dtype == torch.bool else v.clone()
        if unsigned:
            t = _flip(t)
        dist.all_reduce(t, op=red, group=self._groups[ax])
        return {s: (_flip(t) if unsigned else t).to(v.dtype)}

    def ppermute(self, values):
        ((i, j), v), = values.items()
        got = [torch.empty_like(v) for _ in range(self.shape[0])]
        self._dist.all_gather(got, v.contiguous(), group=self._groups[0])
        return {(i, j): got[i - 1] if i > 0 else torch.zeros_like(v)}
