"""Data sources of the port (``repro.data``)."""
from .pipeline import (BOS, EOS, SEP, VERTEX_OFFSET, PathCorpus,
                       SyntheticLM, make_frontend_stub)
