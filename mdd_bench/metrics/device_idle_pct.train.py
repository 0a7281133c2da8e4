"""The share of the traced window in which no operation ran on the
card, in %: one minus the union of the device operations' intervals over
the window."""


def read(rec):
    if not rec.events or rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
