"""The grouped k3 conv's share of its roofline in training: summed bounds
of its forward, dX and dW launches on the traced steps over the device
time of its kernels (forward and dX, and the weight gradient's), percent."""


def read(rec):
    t = rec.family_s("sparse_conv_grouped") + rec.family_s(
        "sparse_conv_grouped_wgrad")
    b = rec.bound_s.get("sparse_conv_grouped", 0.0)
    return 100.0 * b / t if t > 0 and b > 0 else None
