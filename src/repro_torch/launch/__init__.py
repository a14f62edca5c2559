"""Command-line entry points and launch tooling of the port
(``repro.launch``): ``serve`` and ``train``; ``mesh`` (the production
and local ``DeviceMesh``es, ``HARDWARE``); ``specs`` (meta stand-ins for
every arch × shape cell) and ``dryrun`` (each cell's step on meta
tensors over a fake process group of 256 or 512 ranks).  Importing them
builds no mesh and touches no process group."""
