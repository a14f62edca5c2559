"""Known-bad driver: an emitting loop that never consults its deadline."""


def drive_host(work, stats, deadline=None):
    out = []
    while work:  # outermost, touches stats.*, no deadline reference
        chunk = work.pop()
        stats.chunks += 1
        stats.results += len(chunk)
        out.append(chunk)
    return out
