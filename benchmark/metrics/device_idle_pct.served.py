"""The share of the traced stretch in which no operation ran on the card."""


def read(rec):
    stretch = rec.get("stretch")
    if stretch is None or stretch.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - stretch.busy_s / stretch.window_s)
