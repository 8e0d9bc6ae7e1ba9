"""Prometheus metrics of the port's control plane (twin of
kubeml_tpu/metrics): ``prom``."""
