"""Host ms a batch inside the program's "icp" span (dense grids, ICP
loop), traced batches."""


def read(rec):
    return 1e3 * rec.span_s("icp") / rec.units if rec.units else None
