"""Port parity, lockstep tracking under pallas_mom, which a batch routes to
xla as the JAX package does (each align one xla lane program, the suites
as lanes): against the port's own solo xla runs (exactly) and the JAX
package's lockstep (xla), on the first two sequences of
tests/test_multi_sequence.py (the third costs the CPU run ~20 s more;
tests/test_torch_multi_sequence.py takes all three under pallas)."""

import pytest

from test_torch_multi_sequence import (N_FRAMES, _cfg, check_equals_solo,
                                       check_matches_jax, jax_lockstep,
                                       port_runs, sequences)  # noqa: F401


@pytest.fixture(scope="module")
def jax_rows(sequences):  # noqa: F811
    return jax_lockstep(sequences[:2])


def test_lockstep_equals_solo(sequences):  # noqa: F811
    """pallas_mom: the lockstep run (xla lanes) equals the two solo xla
    runs bit for bit."""
    check_equals_solo(*port_runs(sequences[:2], "pallas_mom"))


def test_lockstep_matches_jax(sequences, jax_rows):  # noqa: F811
    """pallas_mom against the JAX package's lockstep (xla): decisions,
    poses and iterations within JAX_BARS, on at least two thirds of the
    frames (each sequence up to its first knife-edge decision)."""
    got, _, _ = port_runs(sequences[:2], "pallas_mom")
    held = check_matches_jax(got, jax_rows, _cfg().FE_InnpThreshold)
    assert held >= 2 * 2 * N_FRAMES // 3, held
