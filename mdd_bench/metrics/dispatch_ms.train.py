"""Host milliseconds the program takes to issue a train step: the
`loop.step` span's duration less the time in it that the host waited on
the card (kineto's `Command Buffer Full` events and synchronising
runtime calls, any thread), over the window's steps."""

from mdd_bench import spans


def read(rec):
    return spans.dispatch_ms(rec)
