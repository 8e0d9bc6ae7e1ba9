"""The data plane of the port (twin of kubeml_tpu/data): epoch plans
(``sharding``), the on-disk dataset registry (``registry``) and its file
ingest (``ingest``), the round loader (``loader``) and the
device-resident dataset cache (``device_cache``)."""
