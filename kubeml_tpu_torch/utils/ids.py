"""Job id generation (copy of kubeml_tpu/utils/ids.py): an 8-char uuid
prefix, parity with ml/pkg/scheduler/util.go:8-10."""

import uuid


def make_job_id() -> str:
    return uuid.uuid4().hex[:8]
