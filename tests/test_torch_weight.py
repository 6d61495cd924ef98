"""Weight on the CPU, on synthetic weight tables: the port's weight_plain,
unsharded and owned, against the JAX package's make_weight and the body
of make_sharded_weight, at run counts around the weight kernel's staged
sample (kernels.WEIGHT_SAMPLE); and a small torch model of the kernel's
two-level search (a sample at stride s, then the segment it picks) held
to searchsorted(right=True) at every s. The kernel itself runs on the
card only (tests/test_torch_kernels.py). Outputs are integers: the
tolerance is 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sshash_tpu.engine import make_weight
from sshash_tpu.parallel.sharded import make_sharded_weight
from sshash_tpu_torch import engine as E
from sshash_tpu_torch import kernels, synthetic
from sshash_tpu_torch.parallel.sharded import split_weight_runs
from one_thread import one_torch_thread  # noqa: F401

S = kernels.WEIGHT_SAMPLE
# run counts: one and two runs, the 5M build's (chip_smoke phase 8), and
# the sample's edge (the kernel's stride s goes from 1 to 2 there)
RUNS = [1, 2, 4307, S - 1, S, S + 1]
NB = 4


def tables(n_runs):
    span = 1000 if n_runs < 4 else 5_000_000 if n_runs < S - 1 else 1 << 31
    return synthetic.weight_tables(n_runs, span, np.random.default_rng(n_runs))


def edge_ids(ep, rng):
    """0, every endpoint, every endpoint - 1 and + 1, past the last, the
    largest ids (2^32 - 2 is the largest kmer id) and random ids."""
    ep = ep.astype(np.int64)
    ids = np.concatenate([[0, ep[-1], ep[-1] + 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1],
                          ep, ep - 1, ep + 1, rng.integers(0, 2 ** 32, 1000)])
    return (ids % 2 ** 32).astype(np.uint32)


def to_torch(host):
    return {key: torch.from_numpy(v.view(np.int32)) for key, v in host.items()}


def u32(t):
    return t.numpy().view(np.uint32)


def jax_weight(host, ids):
    fn = jax.jit(make_weight(None))
    return np.asarray(fn({key: jnp.asarray(v) for key, v in host.items()}, jnp.asarray(ids)))


def shards(host, nb):
    """The weight tables of each of nb bucket shards (host dicts)."""
    ep, vids = split_weight_runs(host["w_endpoints"], host["w_value_ids"], nb)
    n_ep, n_runs = len(ep) // nb, len(vids) // nb
    return [{"w_endpoints": ep[j * n_ep: (j + 1) * n_ep],
             "w_value_ids": vids[j * n_runs: (j + 1) * n_runs],
             "w_dictionary": host["w_dictionary"]} for j in range(nb)]


@pytest.mark.parametrize("n_runs", RUNS)
def test_weight_plain_equals_jax(n_runs):
    host = tables(n_runs)
    ids = edge_ids(host["w_endpoints"], np.random.default_rng(1))
    before = kernels.counts()
    got = E.weight(to_torch(host), torch.from_numpy(ids.view(np.int32)))
    assert kernels.counts() == before  # CPU tensors: the plain version
    assert got.dtype == torch.int32 and got.shape == (len(ids),)
    want = jax_weight(host, ids)
    assert np.array_equal(u32(got), want)
    # and the search itself, in numpy: run = upper bound - 1, clipped
    run = np.searchsorted(host["w_endpoints"], ids, side="right").astype(np.int64) - 1
    run = run.clip(0, n_runs - 1)
    assert np.array_equal(want, host["w_dictionary"][host["w_value_ids"][run]])


@pytest.mark.parametrize("n_runs", RUNS)
def test_owned_weight_equals_jax_shard_body(n_runs):
    """Each shard's owned weights equal make_sharded_weight's body on that
    shard alone (a one-member bucket axis: pmax is the identity), and the
    unsigned max over the shards equals the body over all of them and
    the unsharded weight below the last endpoint."""
    host = tables(n_runs)
    ids = edge_ids(host["w_endpoints"], np.random.default_rng(2))
    it = torch.from_numpy(ids.view(np.int32))
    body = jax.vmap(make_sharded_weight(None), in_axes=(0, None), axis_name="bucket")
    parts = shards(host, NB)
    got = []
    for j, part in enumerate(parts):
        w = u32(E.weight(to_torch(part), it, owned=True))
        one = {key: jnp.asarray(v)[None] for key, v in part.items()}
        assert np.array_equal(w, np.asarray(body(one, jnp.asarray(ids)))[0]), f"shard {j}"
        ep = part["w_endpoints"]
        assert (w[(ids < ep[0]) | (ids >= ep[-1])] == 0).all()
        got.append(w)
    combined = np.max(got, axis=0)
    stacked = {key: jnp.stack([jnp.asarray(p[key]) for p in parts]) for key in parts[0]}
    assert np.array_equal(combined, np.asarray(body(stacked, jnp.asarray(ids)))[0])
    inside = ids < host["w_endpoints"][-1]
    assert np.array_equal(combined[inside], jax_weight(host, ids)[inside])


@pytest.mark.parametrize("n_runs", [1, 2, 5, 4307])
def test_sharded_padding_repeats_the_last_endpoint(n_runs):
    """split_weight_runs pads each part's endpoints with the table's last
    endpoint (and empty parts are that endpoint alone): the upper bound
    counts the repeats as searchsorted(right) does, and no id at or past
    a part's last endpoint is its own."""
    host = tables(n_runs)
    last = host["w_endpoints"][-1]
    parts = shards(host, NB)
    assert sum((p["w_endpoints"] == last).sum() > 1 for p in parts) >= 1
    for part in parts:
        ep = part["w_endpoints"]
        assert len(ep) == len(part["w_value_ids"]) + 1
        assert (np.diff(ep.astype(np.int64)) >= 0).all()
        ids = np.concatenate([ep, ep - 1, ep + 1]).astype(np.uint32)
        w = u32(E.weight(to_torch(part), torch.from_numpy(ids.view(np.int32)), owned=True))
        assert (w[ids >= ep[-1]] == 0).all()
        own = (ids >= ep[0]) & (ids < ep[-1])
        run = np.searchsorted(ep, ids, side="right") - 1
        want = part["w_dictionary"][part["w_value_ids"][run[own]]]
        assert np.array_equal(w[own], want)


def two_level_upper_bound(ep, ids, s, nb):
    """The weight kernel's search (csrc/weight.cu) in torch: the sample of
    every s-th endpoint; its bucket table of nb buckets over the span above
    the first entry (lut[x] = the entries below bucket x, written entry by
    entry as the kernel writes it); per id, its bucket's two counts and as
    many lifting steps as the fullest bucket needs; then log2(s) steps over
    the segment of endpoints (c-1)s+1 .. cs-1 in the table. ep, ids: int64
    u32 values. Returns the number of endpoints <= each id."""
    n_ep = ep.shape[0]
    sample = ep[::s]
    ns = sample.shape[0]
    first, span = int(sample[0]), int(sample[-1] - sample[0])
    shift = max(0, span.bit_length() - (nb.bit_length() - 1))
    q = ((sample - first) >> shift).tolist()
    lut = torch.zeros(nb + 1, dtype=torch.int64)
    for i in range(ns):
        lut[(q[i - 1] + 1 if i else 0): q[i] + 1] = i
    lut[q[-1] + 1:] = ns
    steps = int((lut[1:] - lut[:-1]).max()).bit_length()
    x = torch.where(ids < first, 0, (ids - first) >> shift).clamp(max=nb - 1)
    c, end = lut[x], lut[x + 1]
    h = (1 << steps) >> 1
    while h:
        p = c + h - 1
        c += torch.where((p < end) & (sample[p.clamp(max=ns - 1)] <= ids), h, 0)
        h //= 2
    pos = torch.where(c == 0, 0, (c - 1) * s + 1)
    h = s // 2
    while h:
        p = pos + h - 1
        pos += torch.where((p < n_ep) & (ep[p.clamp(max=n_ep - 1)] <= ids), h, 0)
        h //= 2
    return pos


def plan_stride(n_ep):
    """The kernel's stride: the smallest power of two that leaves fewer
    than WEIGHT_SAMPLE sample entries."""
    s = 1
    while -(-n_ep // s) >= S:
        s *= 2
    return s


@pytest.mark.parametrize("s", [2 ** e for e in range(14)])
def test_two_level_search_model_equals_searchsorted(s):
    """At every stride, on tables with distinct endpoints, with repeats (a
    shard's padding and equal neighbours), of one endpoint and of the
    largest u32 only, at the kernel's bucket count and at 32 buckets: the
    model's count == searchsorted(right=True); and the stride rule at the
    sample's edge."""
    rng = np.random.default_rng(s)
    cases = [tables(n)["w_endpoints"] for n in (1, 2, 5, 63, 100, 255, 4307)]
    cases += [shards(tables(4307), NB)[NB - 1]["w_endpoints"],
              np.repeat(np.sort(rng.integers(0, 1 << 20, 300)), rng.integers(1, 4, 300)),
              np.full(7, 2 ** 32 - 1), np.array([5])]
    for ep in cases:
        ep = np.sort(ep.astype(np.int64))
        ids = torch.from_numpy(edge_ids(ep.astype(np.uint32), rng).astype(np.int64))
        ept = torch.from_numpy(ep)
        want = torch.searchsorted(ept, ids, right=True)
        ns = -(-len(ep) // s)
        # the kernel's bucket count, and 32 buckets (several entries a bucket)
        for nb in (max(32, min(1 << (ns - 1).bit_length(), 8192)), 32):
            got = two_level_upper_bound(ept, ids, s, nb)
            assert torch.equal(got, want), (s, nb, len(ep))
    for n_ep in (S - 1, S, S + 1, 2 * S - 1, 2 * S, (1 << 22) + 1):
        t = plan_stride(n_ep)
        assert -(-n_ep // t) < S and (t == 1 or -(-n_ep // (t // 2)) >= S)
