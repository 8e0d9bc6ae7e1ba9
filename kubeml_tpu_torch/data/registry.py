"""On-disk dataset registry (twin of kubeml_tpu/data/registry.py, over the
same layout, so each package reads the datasets the other wrote):

    $KUBEML_TPU_HOME/datasets/<name>/
        manifest.json          {name, subset_size, train_samples, test_samples,
                                data_shape, data_dtype, label_dtype, created,
                                generation, windows[, files, base]}
        train_data.npy  train_labels.npy
        test_data.npy   test_labels.npy

"Doc d" is samples [d*64, (d+1)*64) of the contiguous array: the unit the
epoch plan shards over workers (data/sharding.py). Arrays are opened
memory-mapped, so slicing a doc range is a zero-copy view.

A dataset the JAX package has appended to names its versioned train files
in the manifest (``files``) and the absolute index of its first retained
sample (``base``); a handle reads both, so such a dataset opens here at its
committed generation. Appending and windowed views (``append``,
``get(window_generations=)``) come with the continual mode and are not
ported yet.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from kubeml_tpu_torch.api.const import STORAGE_SUBSET_SIZE, kubeml_home
from kubeml_tpu_torch.api.errors import DatasetNotFoundError, StorageError
from kubeml_tpu_torch.api.types import DatasetSummary
from kubeml_tpu_torch.utils.names import check_name


def _datasets_root() -> str:
    return os.path.join(kubeml_home(), "datasets")


@dataclass
class DatasetHandle:
    """Open handle to a registered dataset at one committed generation.

    ``files`` maps "<split>_<which>" to the file the manifest names (the
    default ``<split>_<which>.npy`` when absent); ``train_base`` is the
    absolute index of train sample 0 (nonzero once retention has expired
    older generations)."""

    name: str
    subset_size: int
    train_samples: int
    test_samples: int
    path: str
    generation: int = 1
    files: Optional[Dict[str, str]] = None
    train_base: int = 0

    @property
    def num_train_docs(self) -> int:
        return math.ceil(self.train_samples / self.subset_size)

    def _load(self, split: str, which: str) -> np.ndarray:
        default = f"{split}_{which}.npy"
        fname = (self.files or {}).get(f"{split}_{which}", default)
        return np.load(os.path.join(self.path, fname), mmap_mode="r")

    def train_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._load("train", "data"), self._load("train", "labels")

    def test_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._load("test", "data"), self._load("test", "labels")

    def doc_range(self, split: str, start: int, end: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Samples of docs [start, end)."""
        data = self._load(split, "data")
        labels = self._load(split, "labels")
        lo = start * self.subset_size
        hi = min(end * self.subset_size, len(data))
        return data[lo:hi], labels[lo:hi]

    def summary(self) -> DatasetSummary:
        return DatasetSummary(name=self.name,
                              train_set_size=self.train_samples,
                              test_set_size=self.test_samples)


class DatasetRegistry:
    """create / get / exists / list / delete over the on-disk store."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or _datasets_root()

    def _dir(self, name: str) -> str:
        return os.path.join(self.root, check_name(name, "dataset"))

    def exists(self, name: str) -> bool:
        return os.path.isfile(os.path.join(self._dir(name), "manifest.json"))

    def create(self, name: str,
               x_train: np.ndarray, y_train: np.ndarray,
               x_test: np.ndarray, y_test: np.ndarray,
               subset_size: int = STORAGE_SUBSET_SIZE) -> DatasetHandle:
        """Write a dataset and publish it with one atomic rename; a
        duplicate name or mismatched data/label lengths raise."""
        if self.exists(name):
            raise StorageError(f"Dataset {name} already exists")
        if len(x_train) != len(y_train):
            raise StorageError(
                f"train data/labels length mismatch: {len(x_train)} vs "
                f"{len(y_train)}")
        if len(x_test) != len(y_test):
            raise StorageError(
                f"test data/labels length mismatch: {len(x_test)} vs "
                f"{len(y_test)}")
        d = self._dir(name)
        tmp = d + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        try:
            for fname, arr in (("train_data", x_train),
                               ("train_labels", y_train),
                               ("test_data", x_test),
                               ("test_labels", y_test)):
                np.save(os.path.join(tmp, f"{fname}.npy"),
                        np.ascontiguousarray(arr))
            manifest = {
                "name": name,
                "subset_size": subset_size,
                "train_samples": int(len(x_train)),
                "test_samples": int(len(x_test)),
                "data_shape": list(x_train.shape[1:]),
                "data_dtype": str(x_train.dtype),
                "label_dtype": str(y_train.dtype),
                "created": time.time(),
                "generation": 1,
                "windows": [{"generation": 1,
                             "samples": int(len(x_train))}],
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            os.rename(tmp, d)  # atomic publish; races fail loudly
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return self.get(name)

    def get(self, name: str) -> DatasetHandle:
        """Open the dataset at its committed generation."""
        if not self.exists(name):
            raise DatasetNotFoundError(name)
        with open(os.path.join(self._dir(name), "manifest.json")) as f:
            m = json.load(f)
        return DatasetHandle(name=name, subset_size=int(m["subset_size"]),
                             train_samples=int(m["train_samples"]),
                             test_samples=int(m["test_samples"]),
                             path=self._dir(name),
                             generation=int(m.get("generation", 1)),
                             files=m.get("files"),
                             train_base=int(m.get("base", 0)))

    def delete(self, name: str) -> None:
        if not self.exists(name):
            raise DatasetNotFoundError(name)
        shutil.rmtree(self._dir(name))

    def list(self) -> List[DatasetSummary]:
        if not os.path.isdir(self.root):
            return []
        return [self.get(name).summary()
                for name in sorted(os.listdir(self.root))
                if self.exists(name)]
