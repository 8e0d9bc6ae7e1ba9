"""The training job of the port (twin of kubeml_tpu/train): checkpoints
(``checkpoint``), the history store (``history``) and ``TrainJob``
(``job``)."""
