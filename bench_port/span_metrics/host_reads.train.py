"""Blocking device-to-host reads and implicit synchronizations a step
(train/trainer.HOST_READS), traced steps."""


def read(rec):
    n = rec.count("host_reads") if hasattr(rec, "count") else None
    return n / rec.units if n is not None and rec.units else None
