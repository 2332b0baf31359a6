"""roofline_pct.ip_suite: the inner-product suite's calls
(cvo/kernels.ip_suite, two per tracked frame) against the least time
their inputs need (benchmark/counts.py)."""

from benchmark import counts


def read(window, cvo):
    return counts.roofline_pct(
        window, "ip_suite", ("suite_sweep",),
        lambda c, p: counts.ip_suite(c.args, p), cvo)
