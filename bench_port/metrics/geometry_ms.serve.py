"""Host ms a batch inside the program's "geometry" span (kernel maps, row
orders: models/resunet.build_unet_geometry), traced batches."""


def read(rec):
    return 1e3 * rec.span_s("geometry") / rec.units if rec.units else None
