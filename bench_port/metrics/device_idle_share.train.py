"""Percent of the traced window in which no operation ran on the device
(1 - the union of device intervals / the window)."""


def read(rec):
    if not rec.window_s or not rec.busy_s:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
