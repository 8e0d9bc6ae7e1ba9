"""The training control plane of the port (twin of kubeml_tpu/control):
the HTTP base (``httpd``), storage, scheduler (with the throughput
``policy``), parameter server (``ps``), controller, the client SDK
(``client``) and the single-host ``deployment``."""
