"""Training engines of the port (twin of kubeml_tpu/parallel): the K-avg
round (``kavg``) and its weight merge (``merge``), on one device or over
the ranks of a process group (``distributed``, with the ring all-reduce
of ``collectives``), the SyncDP engine (``syncdp``), sequence
parallelism over the seq groups of the rank grid (``ring_attention``,
``ulysses``), the mixture-of-experts routing and expert FFN (``ep``) and
the expert FFN split over the grid's expert groups (``manual``)."""

from kubeml_tpu_torch.parallel.distributed import initialize, is_coordinator

__all__ = ["initialize", "is_coordinator"]
