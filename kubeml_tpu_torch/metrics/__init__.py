"""Metrics of the port (twin of kubeml_tpu/metrics): the Prometheus
registry (``prom``), the cost ledger (``ledger``), compile tracking and
the device-memory watermark (``runtime``), and the latency sketches
(``sketch``)."""

from kubeml_tpu_torch.metrics.ledger import (CostLedger,
                                             CostReconciliationError,
                                             ProgramCost,
                                             attributed_from_snapshot,
                                             merge_cost_snapshots)
from kubeml_tpu_torch.metrics.prom import (Counter, Gauge, Histogram,
                                           HttpMetrics, MetricsRegistry)
from kubeml_tpu_torch.metrics.runtime import HbmWatermark, JitCompileTracker

__all__ = ["Counter", "Gauge", "Histogram", "HttpMetrics",
           "MetricsRegistry", "CostLedger", "CostReconciliationError",
           "ProgramCost", "attributed_from_snapshot",
           "merge_cost_snapshots", "HbmWatermark", "JitCompileTracker"]
