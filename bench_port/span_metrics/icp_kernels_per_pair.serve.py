"""Kernels (copies and fills left out) launched inside the program's
"icp" span and its children, a pair, traced batches."""


def read(rec):
    n = rec.launched_n("icp") if hasattr(rec, "launched_n") else 0
    return n / rec.pairs if n and rec.pairs else None
