"""Device ms a step of the events launched inside the program's
"step.umes" span (the neighbour gathers, moments and intersection
ratios), traced steps."""


def read(rec):
    s = rec.launched_s("step.umes") if hasattr(rec, "launched_s") else 0.0
    return 1e3 * s / rec.units if s > 0 and rec.units else None
