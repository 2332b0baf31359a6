"""The accept test of a loop-closure verification
(src/keyframe_graph.cpp:703-714): the edge goes in iff the posterior
inner product exceeds those under no motion, the RANSAC prior and the
graph's prior, and the cosine of the two clouds' functions is 0.1 or
more."""

from __future__ import annotations


def margin(s: dict) -> float:
    """The accept test's least margin over its four terms, each relative:
    above 0 where every term accepts, at or below 0 where one rejects.
    `s` holds inn_lc_post, inn_lc_pre, inn_lc_prior, inn_prior and
    cos_angle."""
    post = s["inn_lc_post"]
    scale = max(abs(post), 1e-30)
    terms = [(post - s[k]) / scale
             for k in ("inn_lc_pre", "inn_lc_prior", "inn_prior")]
    terms.append((s["cos_angle"] - 0.1) / 0.1)
    return min(terms)


def accept(s: dict) -> bool:
    return (s["inn_lc_post"] > s["inn_lc_pre"]
            and s["inn_lc_post"] > s["inn_lc_prior"]
            and s["inn_lc_post"] > s["inn_prior"]
            and s["cos_angle"] >= 0.1)
