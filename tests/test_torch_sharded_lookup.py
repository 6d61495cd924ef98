"""The port's sharded lookup against the JAX package's ShardedEngine on
more configurations and mesh shapes than tests/test_torch_sharded.py
holds (each JAX mesh program compiles for seconds, so they sit in a file
of their own): canonical with the tie fold, hindex heavy lanes handed
between shards, four-word kmers on eight data rows. Tolerance 0."""

import pytest

from test_torch_sharded import assert_lookup_equals_jax
from one_thread import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name,shape", [("m13_canonical", (2, 4)), ("m3_skew_canonical", (2, 4)),
                                        ("k63", (8, 1))])
def test_lookup_equals_jax(name, shape):
    assert_lookup_equals_jax(name, shape)
