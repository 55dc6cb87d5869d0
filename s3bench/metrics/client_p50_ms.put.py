"""PUT latency as the clients see it over the window: the 50th
percentile (nearest rank, ms) of every PUT completed in it, from send to
acknowledgement; a failed PUT counts as missing every limit. In a closed
loop it follows from the rate (Little's law), so it is the rate's
per-layer companion, not an end-to-end metric of its own."""

from s3bench import traffic


def read(w):
    puts = [r for r in w.records if r[0] == "put"]
    lat = [(r[4] - r[2]) * 1e3 for r in puts if r[4] is not None and r[5] == 200]
    lat += [float("inf")] * (len(puts) - len(lat))
    return traffic.percentile(lat, 50) if lat else None
