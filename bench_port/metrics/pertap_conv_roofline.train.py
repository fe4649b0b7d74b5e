"""The per-tap conv kernels' share of their roofline in training (k5 / k7
layers: sparse_conv_rowtile, sparse_conv_tapsplit forward and dX,
sparse_conv_wgrad): summed bounds over their device time, percent."""


def read(rec):
    t = sum(rec.family_s(f) for f in ("sparse_conv_rowtile",
                                      "sparse_conv_tapsplit",
                                      "sparse_conv_wgrad"))
    b = rec.bound_s.get("pertap", 0.0)
    return 100.0 * b / t if t > 0 and b > 0 else None
