"""Known-bad module: mutable default arguments."""


def launch_counts(names, into={}):
    for n in names:
        into[n] = 0
    return into


def stack(rows, out=list(), *, seen=set()):
    out.extend(rows)
    seen.update(rows)
    return out
