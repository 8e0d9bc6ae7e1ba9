"""The host-side data plane of the port (twin of kubeml_tpu/data): epoch
plans (``sharding``), the on-disk dataset registry (``registry``) and the
round loader (``loader``)."""
