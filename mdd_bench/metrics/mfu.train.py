"""The whole train step's share of the cards' peak, in %: the analytic
FLOPs of every rank's real rows (flops.train_step_flops at each row's
own frames and transcript length) over the traced window's seconds, over
the compute dtype's dense peak times the cards."""

from mdd_bench import flops


def read(rec):
    peak = flops.peak_flops(rec.card, rec.cfg["compute_dtype"])
    if peak is None or rec.window_s <= 0 or not rec.flops:
        return None
    return 100.0 * rec.flops / rec.window_s / (peak * rec.cards)
