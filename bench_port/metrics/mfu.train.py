"""The backbone's forward, dX and dW operations a step (counted on the
reference's maps of the traced batches) times the run's steps, over the
window and the bf16 peak, percent."""


def read(rec):
    if not rec.model_flops or not rec.run_window_s:
        return None
    return 100.0 * rec.model_flops * rec.run_units / (
        rec.run_window_s * rec.peaks["bf16_flops"])
