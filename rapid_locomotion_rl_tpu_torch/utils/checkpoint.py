"""Loading the JAX package's pickled checkpoints (plain NumPy pytrees).

The pickles were written under numpy 2, whose arrays pickle as
``numpy._core.multiarray``; under an older numpy that module is
``numpy.core.multiarray``, so :func:`load_pytree` maps the name.
Unpickling can run code: load only files this project wrote.
"""

from __future__ import annotations

import pickle
from typing import Any

import numpy as np


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("numpy._core") and not hasattr(np, "_core"):
            module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)


def load_pytree(path: str) -> Any:
    with open(path, "rb") as f:
        return _Unpickler(f).load()
