"""Fixture exercising the port's suppression token (unused-import)."""
import ctypes  # repro-torch-lint: disable=unused-import
import json  # repro-torch-lint: disable=all
import os  # repro-lint: disable=unused-import (repro's token: not read)
import sys  # no suppression: this one must still be flagged
