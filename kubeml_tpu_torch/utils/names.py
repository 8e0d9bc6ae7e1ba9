"""Resource-name validation (copy of kubeml_tpu/utils/names.py): dataset,
function and job names become paths under KUBEML_TPU_HOME, so they may
hold no path separator and no dot-traversal."""

import re

from kubeml_tpu_torch.api.errors import InvalidArgsError

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,127}$")


def check_name(name: str, kind: str = "resource") -> str:
    if not isinstance(name, str) or not _NAME_RE.match(name) or ".." in name:
        raise InvalidArgsError(
            f"invalid {kind} name {name!r}: must match "
            "[A-Za-z0-9][A-Za-z0-9._-]* with no '..'")
    return name
