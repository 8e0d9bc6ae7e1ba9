"""The training job of the port (twin of kubeml_tpu/train): checkpoints
(``checkpoint``), the history store (``history``), ``TrainJob``
(``job``), the user function registry (``functionlib``) and the per-job
server process (``jobserver``)."""
