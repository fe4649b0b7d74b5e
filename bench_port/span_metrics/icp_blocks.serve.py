"""ICP blocks run a batch, all stages (pipeline/icp.COUNTS: one host read
a block), traced batches."""


def read(rec):
    n = rec.count("icp.blocks") if hasattr(rec, "count") else None
    return n / rec.units if n and rec.units else None
