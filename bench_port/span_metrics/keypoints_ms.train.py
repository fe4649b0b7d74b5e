"""Host ms a step inside the program's "step.keypoints" span (the
per-pair keypoint selection: ball queries and top-k), traced steps."""


def read(rec):
    s = rec.span_s("step.keypoints")
    return 1e3 * s / rec.units if rec.units and s > 0 else None
