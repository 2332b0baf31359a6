"""roofline_pct.moment_flow_step: the moment kernel's calls
(cvo/kernels.moment_flow_step, one align iteration each) against the
least time their inputs need (benchmark/counts.py)."""

from benchmark import counts


def read(window, cvo):
    return counts.roofline_pct(
        window, "moment_flow_step", ("moment_keep_pass", "moment_sum_pass"),
        lambda c, p: counts.moment_flow_step(c.args, p), cvo)
