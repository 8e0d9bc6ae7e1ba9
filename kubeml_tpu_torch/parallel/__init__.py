"""Training engines of the port (twin of kubeml_tpu/parallel): the K-avg
round (``kavg``) and its weight merge (``merge``), on one device or over
the ranks of a process group (``distributed``, with the ring all-reduce
of ``collectives``), the SyncDP engine (``syncdp``), sequence
parallelism over the seq groups of the rank grid (``ring_attention``,
``ulysses``), the mixture-of-experts routing and expert FFN (``ep``),
the expert FFN and the Megatron layers split over the grid's expert and
model groups (``manual``, with the rule table of ``tp``) and the GPipe
pipeline over its stage groups (``pp``)."""

from kubeml_tpu_torch.parallel.distributed import initialize, is_coordinator

__all__ = ["initialize", "is_coordinator"]
