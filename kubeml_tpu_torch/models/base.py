"""Model-contract pieces the serving slice needs (twin of
kubeml_tpu/models/base.py; the training contract is ported later)."""

from __future__ import annotations

PAD_ID = 0  # token id 0 is padding in every text model of the package


class InferenceInputError(ValueError):
    """A model rejected the caller-supplied inference payload (bad shape,
    overlong prompt, ...). Serving layers translate exactly this type to
    a 4xx error; any other exception stays a server fault (5xx)."""
