"""Training engines of the port (twin of kubeml_tpu/parallel): the
one-device K-avg round (``kavg``) and its weight merge (``merge``)."""
