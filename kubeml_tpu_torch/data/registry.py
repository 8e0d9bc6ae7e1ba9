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

Streaming appends (the continual mode): ``append`` adds a generation-
tagged chunk to the train split. It writes NEW versioned array files
(``train_data.v<G>.npy``) holding the whole retained window, then commits
by ``os.replace``-ing manifest.json, which names the files it describes:
a reader holding any committed manifest sees a consistent (files,
lengths) pair, never a torn append. Generations are strictly monotonic
per dataset; ``retention_generations`` expires old generations by
dropping their samples from the FRONT of the window and advancing the
absolute coordinate ``base`` of its first sample, so doc addressing is
unchanged (doc 0 is the oldest retained sample). Manifests and files are
the JAX package's, byte for byte in layout and keys: a dataset either
package creates and appends to reads identically in the other.
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
from kubeml_tpu_torch.api.errors import (DatasetNotFoundError,
                                         InvalidFormatError, StorageError)
from kubeml_tpu_torch.api.types import DatasetSummary
from kubeml_tpu_torch.utils.names import check_name


def _datasets_root() -> str:
    return os.path.join(kubeml_home(), "datasets")


@dataclass
class DatasetHandle:
    """Open handle to a registered dataset at one committed generation.

    ``generation`` is the commit counter: 1 at create, +1 per append (or
    the producer's explicit monotone tag). ``files`` maps
    "<split>_<which>" to the file the manifest names (the default
    ``<split>_<which>.npy`` when absent): a handle is an immutable
    snapshot, re-``get`` the registry to see newer appends.
    ``train_base`` is the absolute index (in the dataset's append-forever
    coordinates) of this handle's train sample 0, so two handles agree on
    a sample's identity after retention shifted the stored array: the
    device cache keys its incremental lane reuse on absolute ranges.
    ``train_offset`` is the further doc-aligned front slice a
    ``window_generations`` view applies (folded into ``train_base``)."""

    name: str
    subset_size: int
    train_samples: int
    test_samples: int
    path: str
    generation: int = 1
    files: Optional[Dict[str, str]] = None
    train_base: int = 0
    train_offset: int = 0

    @property
    def num_train_docs(self) -> int:
        return math.ceil(self.train_samples / self.subset_size)

    @property
    def num_test_docs(self) -> int:
        return math.ceil(self.test_samples / self.subset_size)

    def _load(self, split: str, which: str) -> np.ndarray:
        default = f"{split}_{which}.npy"
        fname = (self.files or {}).get(f"{split}_{which}", default)
        arr = np.load(os.path.join(self.path, fname), mmap_mode="r")
        if split == "train" and self.train_offset:
            arr = arr[self.train_offset:]   # a window: still an mmap view
        return arr

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
    """create / append / get / exists / list / delete over the on-disk
    store."""

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

    def append(self, name: str,
               x_train: np.ndarray, y_train: np.ndarray,
               generation: Optional[int] = None,
               retention_generations: int = 0) -> DatasetHandle:
        """Append a generation-tagged chunk to the train split.

        Validation fails with a 400 (InvalidFormatError) before anything
        is written: per-sample shape or dtype drift would corrupt every
        consumer of the one contiguous array, and a non-monotonic
        ``generation`` means a stale or duplicated producer. The commit
        is one ``os.replace`` of manifest.json over freshly written
        versioned files. ``retention_generations`` > 0 keeps only that
        many newest generations."""
        if not self.exists(name):
            raise DatasetNotFoundError(name)
        d = self._dir(name)
        with open(os.path.join(d, "manifest.json")) as f:
            m = json.load(f)
        cur_gen = int(m.get("generation", 1))
        if generation is None:
            generation = cur_gen + 1
        generation = int(generation)
        if generation <= cur_gen:
            raise InvalidFormatError(
                f"non-monotonic generation {generation} for dataset "
                f"{name}: current generation is {cur_gen}")
        if len(x_train) != len(y_train):
            raise InvalidFormatError(
                f"append data/labels length mismatch: "
                f"{len(x_train)} vs {len(y_train)}")
        if len(x_train) == 0:
            raise InvalidFormatError("append chunk is empty")
        if list(x_train.shape[1:]) != list(m["data_shape"]):
            raise InvalidFormatError(
                f"append sample shape {list(x_train.shape[1:])} does not "
                f"match dataset shape {m['data_shape']}")
        if str(x_train.dtype) != m["data_dtype"]:
            raise InvalidFormatError(
                f"append data dtype {x_train.dtype} does not match "
                f"dataset dtype {m['data_dtype']}")
        if str(y_train.dtype) != m["label_dtype"]:
            raise InvalidFormatError(
                f"append label dtype {y_train.dtype} does not match "
                f"dataset label dtype {m['label_dtype']}")

        old_data, old_labels = self.get(name).train_arrays()
        windows = list(m.get("windows",
                             [{"generation": cur_gen,
                               "samples": int(m["train_samples"])}]))
        windows.append({"generation": generation,
                        "samples": int(len(x_train))})
        data = np.concatenate(
            [np.asarray(old_data), np.ascontiguousarray(x_train)])
        labels = np.concatenate(
            [np.asarray(old_labels), np.ascontiguousarray(y_train)])
        base = int(m.get("base", 0))
        if retention_generations > 0 and len(windows) > retention_generations:
            expired = windows[:-retention_generations]
            windows = windows[-retention_generations:]
            drop = sum(int(w["samples"]) for w in expired)
            data, labels = data[drop:], labels[drop:]
            # the retained window's first sample, in absolute coordinates
            base += drop

        data_file = f"train_data.v{generation}.npy"
        labels_file = f"train_labels.v{generation}.npy"
        np.save(os.path.join(d, data_file), np.ascontiguousarray(data))
        np.save(os.path.join(d, labels_file), np.ascontiguousarray(labels))
        files = dict(m.get("files") or {})
        prev = (files.get("train_data"), files.get("train_labels"))
        files["train_data"] = data_file
        files["train_labels"] = labels_file
        m.update(generation=generation, windows=windows, files=files,
                 train_samples=int(len(data)), base=base,
                 appended=time.time())
        tmp = os.path.join(d, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(m, f)
        os.replace(tmp, os.path.join(d, "manifest.json"))  # the commit
        # keep the previous version for a reader that resolved its
        # manifest just before the commit; drop anything older
        for fname in os.listdir(d):
            if (fname.startswith(("train_data.v", "train_labels.v"))
                    and fname not in (data_file, labels_file)
                    and fname not in prev):
                try:
                    os.remove(os.path.join(d, fname))
                except OSError:
                    pass
        return self.get(name)

    def get(self, name: str,
            window_generations: int = 0) -> DatasetHandle:
        """Open the dataset at its committed generation.

        ``window_generations`` > 0 gives a view over only the newest W
        generations, even where retention keeps more: its front offset
        is rounded DOWN to a doc boundary, so doc addressing stays exact
        (the view may hold a partial doc of the (W+1)-th newest
        generation rather than split one)."""
        if not self.exists(name):
            raise DatasetNotFoundError(name)
        with open(os.path.join(self._dir(name), "manifest.json")) as f:
            m = json.load(f)
        subset = int(m["subset_size"])
        total = int(m["train_samples"])
        offset = 0
        windows = m.get("windows") or []
        if window_generations > 0 and windows:
            keep = sum(int(w["samples"])
                       for w in windows[-window_generations:])
            offset = (max(0, total - keep) // subset) * subset
        return DatasetHandle(name=name, subset_size=subset,
                             train_samples=total - offset,
                             test_samples=int(m["test_samples"]),
                             path=self._dir(name),
                             generation=int(m.get("generation", 1)),
                             files=m.get("files"),
                             train_base=int(m.get("base", 0)) + offset,
                             train_offset=offset)

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
