"""corr_scores_fused's share of its roofline: the summed bounds of the
reference's scorer calls on the traced batch (in-radius triples counted,
bench_port/harness/counts.py) over the family's device time, percent."""


def read(rec):
    t = rec.family_s("corr_scores_fused")
    b = rec.bound_s.get("corr_scores_fused", 0.0)
    return 100.0 * b / t if t > 0 and b > 0 else None
