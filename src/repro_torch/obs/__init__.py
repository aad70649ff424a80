"""Runtime observability of the port: the span tracer (``trace``) and
the metrics registry (``registry``), copies of the JAX package's
pure-Python modules."""
from . import registry, trace                                  # noqa: F401
from .registry import REGISTRY, MetricsRegistry                # noqa: F401
from .trace import TRACER, Span, Tracer                        # noqa: F401

__all__ = [
    "trace", "registry",
    "TRACER", "Tracer", "Span",
    "REGISTRY", "MetricsRegistry",
]
