"""Known-good port module: every anchored section exists.

The kernels follow DESIGN.md §9; serving follows DESIGN.md §7-8.
"""
