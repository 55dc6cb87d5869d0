"""The dispatcher's device window per dispatch over the window (ms): the
host clock around the device call, copies to and from the card
included (parallel/dispatcher.py ``device_s``)."""


def read(w):
    n = w.delta("dispatch", "dispatches")
    return w.delta("dispatch", "device_s") / n * 1e3 if n else None
