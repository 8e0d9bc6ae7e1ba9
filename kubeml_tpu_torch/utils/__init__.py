"""Small host-side helpers of the port (twin of kubeml_tpu/utils)."""
