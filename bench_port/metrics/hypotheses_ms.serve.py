"""Host ms a batch inside the program's "hypotheses" span (keypoints, UMEs,
matching, hypotheses, scoring and consensus), traced batches."""


def read(rec):
    return 1e3 * rec.span_s("hypotheses") / rec.units if rec.units else None
