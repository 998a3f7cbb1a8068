"""The whole forward's share of the card's peak: the least time of its
matrix products, each at the peak of its type (roofline/work.py), over the
traced stretch's time per forward."""

from benchmark.roofline import work


def read(rec):
    stretch, forwards = rec.get("stretch"), rec.get("forwards")
    if stretch is None or not forwards:
        return None
    least = work.matmul_least_s(rec["ref"], rec["dims"], rec["batch"], rec["token_filter"])
    return 100.0 * least * forwards / stretch.window_s
