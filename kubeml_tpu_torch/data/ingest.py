"""Dataset ingest (copy of kubeml_tpu/data/ingest.py): the four files of
the storage service's upload path (x-train, y-train, x-test, y-test) in
.npy or .pkl, validated and registered, and the two train files of a
generation-tagged append."""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from kubeml_tpu_torch.api.errors import InvalidFormatError
from kubeml_tpu_torch.data.registry import DatasetHandle, DatasetRegistry


def load_array_file(path: str) -> np.ndarray:
    """Load a .npy or .pkl array file (the two formats the reference
    accepts — python/storage/api.py:93-103)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return np.load(path, allow_pickle=False)
    if ext in (".pkl", ".pickle"):
        with open(path, "rb") as f:
            obj = pickle.load(f)
        arr = np.asarray(obj)
        if arr.dtype == object:
            raise InvalidFormatError(f"{path}: pickled object is not an array")
        return arr
    raise InvalidFormatError(
        f"Unsupported dataset file extension {ext!r} (want .npy or .pkl)")


def ingest_files(name: str, x_train: str, y_train: str,
                 x_test: str, y_test: str,
                 registry: Optional[DatasetRegistry] = None) -> DatasetHandle:
    """Ingest the four dataset files into the registry; length and shape
    drift between them is the uploader's fault, a 400."""
    registry = registry or DatasetRegistry()
    arrays = {}
    for key, path in (("x_train", x_train), ("y_train", y_train),
                      ("x_test", x_test), ("y_test", y_test)):
        if not os.path.isfile(path):
            raise InvalidFormatError(f"{key} file not found: {path}")
        arrays[key] = load_array_file(path)
    if len(arrays["x_train"]) != len(arrays["y_train"]):
        raise InvalidFormatError(
            f"train data/labels length mismatch: "
            f"{len(arrays['x_train'])} vs {len(arrays['y_train'])}")
    if len(arrays["x_test"]) != len(arrays["y_test"]):
        raise InvalidFormatError(
            f"test data/labels length mismatch: "
            f"{len(arrays['x_test'])} vs {len(arrays['y_test'])}")
    if arrays["x_train"].shape[1:] != arrays["x_test"].shape[1:]:
        raise InvalidFormatError(
            f"train/test sample shape mismatch: "
            f"{list(arrays['x_train'].shape[1:])} vs "
            f"{list(arrays['x_test'].shape[1:])}")
    return registry.create(name, arrays["x_train"], arrays["y_train"],
                           arrays["x_test"], arrays["y_test"])


def append_files(name: str, x_train: str, y_train: str,
                 generation: Optional[int] = None,
                 retention_generations: int = 0,
                 registry: Optional[DatasetRegistry] = None) -> DatasetHandle:
    """Append one generation-tagged train chunk (two files) to a live
    dataset; the registry refuses shape/dtype drift and non-monotonic
    generation tags with 400s before anything is committed."""
    registry = registry or DatasetRegistry()
    arrays = {}
    for key, path in (("x_train", x_train), ("y_train", y_train)):
        if not os.path.isfile(path):
            raise InvalidFormatError(f"{key} file not found: {path}")
        arrays[key] = load_array_file(path)
    return registry.append(name, arrays["x_train"], arrays["y_train"],
                           generation=generation,
                           retention_generations=retention_generations)
