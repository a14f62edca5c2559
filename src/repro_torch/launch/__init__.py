"""Command-line entry points of the port (``repro.launch``): ``serve``.
``train`` and ``dryrun`` wait for ROADMAP queue 1, item 9."""
