"""Percent of the pair-blocks ICP ran in which the pair had not yet
converged (pipeline/icp.COUNTS, all stages), traced batches."""


def read(rec):
    if not hasattr(rec, "count"):
        return None
    live, run = rec.count("icp.live_pair_blocks"), rec.count("icp.pair_blocks")
    return 100.0 * live / run if live is not None and run else None
