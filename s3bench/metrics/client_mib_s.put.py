"""PUT bytes acknowledged in the window over its seconds (MiB/s), as the
clients see them: the rate a user feels. The host's speed sets it, and
the host's speed swings from minute to minute, so it stands here beside
the card's cost and not as an end-to-end metric."""


def read(w):
    if w.seconds <= 0:
        return None
    good = [r for r in w.records if r[0] == "put" and r[5] == 200]
    return sum(r[6] for r in good) / w.seconds / (1 << 20) if good else None
