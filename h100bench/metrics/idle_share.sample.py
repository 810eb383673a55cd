"""The share of the traced window in which no kernel, memcpy or memset ran
on the card: 1 − (union of their intervals) / window, in percent."""


def read(rec):
    if not rec.work:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
