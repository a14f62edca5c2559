"""Known-good module: None defaults, built inside."""


def launch_counts(names, into=None):
    into = {} if into is None else into
    for n in names:
        into[n] = 0
    return into


def stack(rows, out=None, *, width=(1, 2)):
    out = [] if out is None else out
    out.extend(rows)
    return out, width
