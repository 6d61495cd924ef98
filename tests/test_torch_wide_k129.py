"""tests/test_torch_wide.py's checks on k129_canonical (W = 9, the kernels'
runtime-width form), in a file of its own: the JAX package compiles each
of its programs for minutes at this width."""

from test_torch_wide import (check_access_iteration_weight, check_layout, check_lookup,
                             check_navigation, check_sharded, check_streaming, check_ties,
                             one_torch_thread)  # noqa: F401 (an autouse fixture)

NAME = "k129_canonical"


def test_layout_equals_jax():
    check_layout(NAME)


def test_lookup_equals_jax_and_oracles():
    check_lookup(NAME)


def test_canonical_ties_equal_jax_cond_path():
    check_ties(NAME)


def test_access_iteration_equal_jax():
    assert not check_access_iteration_weight(NAME)  # the two-round form


def test_navigation_equals_oracles():
    check_navigation(NAME, jax_device=False)


def test_streaming_equals_host_streams():
    check_streaming(NAME, jax_device=False)


def test_sharded_lookup_equals_jax():
    check_sharded(NAME, (1, 4))
