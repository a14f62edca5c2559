"""Known-good module: the exceptions named."""


def nvcc_version(run):
    try:
        return run(["nvcc", "--version"])
    except (OSError, ValueError):
        return None
