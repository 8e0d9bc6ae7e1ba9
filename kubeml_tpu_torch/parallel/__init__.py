"""Training engines of the port (twin of kubeml_tpu/parallel): the
one-device K-avg round (``kavg``), its weight merge (``merge``) and the
mixture-of-experts routing and expert FFN on one device (``ep``)."""
