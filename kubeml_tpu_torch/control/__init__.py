"""Control-plane pieces of the port (twin of kubeml_tpu/control): so far
the scheduler's throughput policy (``policy``)."""
