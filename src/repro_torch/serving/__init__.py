"""Serving in the port: the LM engine (``repro.serving.engine``).  The
PathEnum front-ends (``hcpe``, ``async_server``, ``registry``,
``metrics``) wait for ROADMAP queue 1, item 7."""
from .engine import Request, ServeEngine
