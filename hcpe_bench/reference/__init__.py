"""The plain reference the benchmark judges the program's answers by:
plain PyTorch over the benchmark's own edge list, importing nothing of
the program (``paths``)."""
