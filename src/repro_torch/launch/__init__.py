"""Command-line entry points of the port (``repro.launch``): ``serve``
and ``train``.  ``mesh`` waits for ROADMAP queue 1, item 9.6, and
``dryrun`` for item 9.7."""
