"""The backbone's forward operations of the run's batches (counted on the
reference's maps) over the window and the bf16 peak, percent."""


def read(rec):
    if not rec.model_flops or not rec.run_window_s:
        return None
    return 100.0 * rec.model_flops * rec.run_units / (
        rec.run_window_s * rec.peaks["bf16_flops"])
