"""Stripe blocks a device dispatch carried, on average over the window
(parallel/dispatcher.py stats; padding not counted)."""


def read(w):
    n = w.delta("dispatch", "dispatches")
    return w.delta("dispatch", "blocks") / n if n else None
