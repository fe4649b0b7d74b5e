"""Host ms a batch inside the program's "hypotheses.score" span (the
weighted features and the correlator cascade), traced batches."""


def read(rec):
    s = rec.span_s("hypotheses.score")
    return 1e3 * s / rec.units if rec.units and s > 0 else None
