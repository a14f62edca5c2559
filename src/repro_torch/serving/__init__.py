"""Serving in the port: the LM engine (``engine``, the port of
``repro.serving.engine``) and the PathEnum front-ends (ported from
``repro.serving``): the HcPE batch server (``hcpe``, DESIGN.md §4), the
async deadline-aware server (``async_server``, §7), the tenant-graph
registry with streaming mutation and live quotas (``registry``, §8,
§12) and the metrics control plane (``metrics``, §12).  The
front-ends' default engine runs on the card (``device="cuda"``,
``backend="device"``)."""

from . import engine  # noqa: F401
from .async_server import AsyncHcPEServer, AsyncServeStats
from .engine import Request, ServeEngine
from .hcpe import (BatchServeReport, HcPEServer, PathQueryRequest,
                   PathQueryResponse, STATUS_OK, STATUS_REJECTED_QUEUE_FULL,
                   STATUS_REJECTED_QUOTA, STATUS_REJECTED_SHUTDOWN,
                   STATUS_REJECTED_NO_WEIGHTS, STATUS_REJECTED_TENANT_QUOTA,
                   STATUS_REJECTED_UNKNOWN_GRAPH)
from .metrics import MetricsSnapshot, TenantMetrics, snapshot
from .registry import GraphRegistry, TenantEntry

__all__ = ["engine", "HcPEServer", "PathQueryRequest", "PathQueryResponse",
           "BatchServeReport", "AsyncHcPEServer", "AsyncServeStats",
           "GraphRegistry", "TenantEntry",
           "MetricsSnapshot", "TenantMetrics", "snapshot",
           "STATUS_OK", "STATUS_REJECTED_QUEUE_FULL", "STATUS_REJECTED_QUOTA",
           "STATUS_REJECTED_TENANT_QUOTA", "STATUS_REJECTED_UNKNOWN_GRAPH",
           "STATUS_REJECTED_SHUTDOWN", "STATUS_REJECTED_NO_WEIGHTS",
           "Request", "ServeEngine"]
