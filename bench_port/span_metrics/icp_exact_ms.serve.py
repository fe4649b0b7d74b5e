"""Host ms a batch inside the program's "icp.exact" span (the exact
correlator-cloud ICP stage), traced batches."""


def read(rec):
    s = rec.span_s("icp.exact")
    return 1e3 * s / rec.units if rec.units and s > 0 else None
