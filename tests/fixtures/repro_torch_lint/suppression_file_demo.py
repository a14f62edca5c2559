"""Fixture exercising file-level suppression (unused-import rule)."""
# repro-torch-lint: disable-file=unused-import
import ctypes
import json
import sys
