"""Host ms a batch inside the program's "forward" span (the backbone,
models/resunet.ResUNet), traced batches."""


def read(rec):
    return 1e3 * rec.span_s("forward") / rec.units if rec.units else None
