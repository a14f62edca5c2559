"""Known-bad port module: anchors sections DESIGN.md does not have.

The port's kernels follow DESIGN.md §14, and its serving DESIGN.md §12-15.
"""
