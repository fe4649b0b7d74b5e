"""The per-tap conv kernels' share of their roofline in serving (k5 / k7
layers, a no-grad forward: sparse_conv_rowtile, sparse_conv_tapsplit):
the summed bounds of the traced batch's per-tap layers over the device
time of the two families' kernels, percent."""


def read(rec):
    t = sum(rec.family_s(f) for f in ("sparse_conv_rowtile",
                                      "sparse_conv_tapsplit"))
    b = rec.bound_s.get("pertap", 0.0)
    return 100.0 * b / t if t > 0 and b > 0 else None
