"""The grouped k3 conv kernels' share of their roofline: the summed bounds
of the traced batch's grouped layers (bench_port/harness/counts.py) over
the device time of the family's kernels in the trace, percent."""


def read(rec):
    t = rec.family_s("sparse_conv_grouped")
    b = rec.bound_s.get("sparse_conv_grouped", 0.0)
    return 100.0 * b / t if t > 0 and b > 0 else None
