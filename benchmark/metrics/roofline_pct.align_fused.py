"""roofline_pct.align_fused: the single-launch align's calls
(cvo/kernels.align_fused, a whole alignment each, its own iteration
count) against the least time their inputs need (benchmark/counts.py)."""

from benchmark import counts


def read(window, cvo):
    return counts.roofline_pct(
        window, "align_fused", ("align_kernel",),
        lambda c, p: counts.align_fused(
            c.args, counts.iterations_run(c.out[3], p), p), cvo)
