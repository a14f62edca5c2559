"""Known-bad module: a bare except swallowing everything."""


def nvcc_version(run):
    try:
        return run(["nvcc", "--version"])
    except:  # noqa: E722 — the rule under test
        return None
