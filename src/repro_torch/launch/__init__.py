"""Command-line entry points of the port (``repro.launch``): ``serve``.
``train`` and ``dryrun`` wait for ROADMAP queue 1, items 9.6 and 9.7."""
