"""Host ms a step inside the optimizer's step span (PyTorch's own
"Optimizer.step#OptaxAdam.step"), traced steps."""


def read(rec):
    s = rec.span_s("Optimizer.step#OptaxAdam.step")
    return 1e3 * s / rec.units if rec.units and s > 0 else None
