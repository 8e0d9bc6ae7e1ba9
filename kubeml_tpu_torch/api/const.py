"""Constants of the port (copy of the values kubeml_tpu/api/const.py
defines; the port imports nothing of the JAX package)."""

import os

# samples per storage "doc": the unit that shards an epoch over workers
STORAGE_SUBSET_SIZE = 64

# throughput policy thresholds (the scheduler's parallelism advisor)
POLICY_UPPER_BOUND = 1.2   # epoch slowed >= 20%  -> parallelism -1
POLICY_LOWER_BOUND = 1.05  # epoch within 5%      -> parallelism +1


def kubeml_home() -> str:
    """Root of the on-disk dataset, model and history planes: the same
    ``KUBEML_TPU_HOME`` variable and default as the JAX package, so the
    two packages share one store."""
    return os.environ.get("KUBEML_TPU_HOME",
                          os.path.expanduser("~/.kubeml_tpu"))
