"""User "function" registry — deploying model code by name (copy of
kubeml_tpu/train/functionlib.py over the port's model classes).

Parity with `kubeml fn create/delete/list` (ml/pkg/kubeml-cli/cmd/
function.go:96-128): a single user Python file (a KubeModel subclass and,
optionally, a KubeDataset subclass of this package) is registered into
$KUBEML_TPU_HOME/functions/ and imported by the job runner, with the
reference's 256 KB limit. The JAX package registers into the same
directory, so a file written for one package is resolved by the other
only if it subclasses that package's classes.

Resolution order when training names a function: the user-registered
file first, then the port's built-in models (``models.get_model``).
"""

from __future__ import annotations

import importlib.util
import inspect
import os
import shutil
import sys
from typing import List, Optional, Tuple, Type

from kubeml_tpu_torch.api.const import kubeml_home
from kubeml_tpu_torch.api.errors import FunctionNotFoundError, InvalidArgsError
from kubeml_tpu_torch.models import get_model
from kubeml_tpu_torch.models.base import KubeDataset, KubeModel
from kubeml_tpu_torch.utils.names import check_name

# single-file archive literal limit (cmd/function.go: fission 256KB limit)
MAX_FUNCTION_SIZE = 256 * 1024


class FunctionRegistry:
    def __init__(self, root: Optional[str] = None):
        self.root = root or os.path.join(kubeml_home(), "functions")

    def _path(self, name: str) -> str:
        return os.path.join(self.root, f"{check_name(name, 'function')}.py")

    def exists(self, name: str) -> bool:
        return os.path.isfile(self._path(name))

    def create(self, name: str, code_path: str) -> str:
        if not os.path.isfile(code_path):
            raise InvalidArgsError(f"code file not found: {code_path}")
        if os.path.getsize(code_path) > MAX_FUNCTION_SIZE:
            raise InvalidArgsError(
                f"function file exceeds {MAX_FUNCTION_SIZE} bytes")
        if self.exists(name):
            raise InvalidArgsError(f"function {name} already exists")
        # validate the file actually defines a KubeModel before deploying
        self._load_classes_from_file(code_path, name)
        os.makedirs(self.root, exist_ok=True)
        shutil.copyfile(code_path, self._path(name))
        return self._path(name)

    def delete(self, name: str) -> None:
        if not self.exists(name):
            raise FunctionNotFoundError(name)
        os.remove(self._path(name))

    def list(self) -> List[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(f[:-3] for f in os.listdir(self.root)
                      if f.endswith(".py"))

    # ------------------------------------------------------------ resolution

    def resolve(self, name: str) -> Tuple[Type[KubeModel],
                                          Optional[Type[KubeDataset]]]:
        """Resolve a function name to (model_cls, dataset_cls or None)."""
        if self.exists(name):
            return self._load_classes_from_file(self._path(name), name)
        builtin = get_model(name)
        if builtin is not None:
            return builtin, getattr(builtin, "dataset_cls", None)
        raise FunctionNotFoundError(name)

    @staticmethod
    def _load_classes_from_file(path: str, name: str):
        mod_name = f"kubeml_torch_user_fn_{name}"
        spec = importlib.util.spec_from_file_location(mod_name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = module
        try:
            spec.loader.exec_module(module)
        except Exception as e:
            raise InvalidArgsError(
                f"function file failed to import: {e}") from e
        model_cls = dataset_cls = None
        for _, obj in inspect.getmembers(module, inspect.isclass):
            if obj.__module__ != mod_name:
                continue
            if issubclass(obj, KubeModel) and not inspect.isabstract(obj):
                model_cls = obj
            if issubclass(obj, KubeDataset) and obj is not KubeDataset:
                dataset_cls = obj
        if model_cls is None:
            raise InvalidArgsError(
                f"{path} defines no concrete KubeModel subclass")
        return model_cls, dataset_cls
