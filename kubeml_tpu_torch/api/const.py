"""Constants of the port (copy of the values kubeml_tpu/api/const.py
defines; the port imports nothing of the JAX package)."""

import os

# samples per storage "doc": the unit that shards an epoch over workers
STORAGE_SUBSET_SIZE = 64

# largest batch a train request may ask for (the reference CLI's check,
# ml/pkg/kubeml-cli/cmd/train.go:15)
MAX_BATCH_SIZE = 1024

# service ports of a long-running deployment (start_deployment's
# use_default_ports) and the client's default controller URL
CONTROLLER_PORT = int(os.environ.get("KUBEML_CONTROLLER_PORT", "9673"))
SCHEDULER_PORT = int(os.environ.get("KUBEML_SCHEDULER_PORT", "9674"))
PS_PORT = int(os.environ.get("KUBEML_PS_PORT", "9675"))
STORAGE_PORT = int(os.environ.get("KUBEML_STORAGE_PORT", "9676"))
CONTROLLER_URL = os.environ.get("KUBEML_CONTROLLER_URL",
                                f"http://127.0.0.1:{CONTROLLER_PORT}")

# throughput policy thresholds (the scheduler's parallelism advisor)
POLICY_UPPER_BOUND = 1.2   # epoch slowed >= 20%  -> parallelism -1
POLICY_LOWER_BOUND = 1.05  # epoch within 5%      -> parallelism +1


def kubeml_home() -> str:
    """Root of the on-disk dataset, model and history planes: the same
    ``KUBEML_TPU_HOME`` variable and default as the JAX package, so the
    two packages share one store."""
    return os.environ.get("KUBEML_TPU_HOME",
                          os.path.expanduser("~/.kubeml_tpu"))
