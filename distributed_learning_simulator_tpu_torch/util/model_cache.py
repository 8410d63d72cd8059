"""The worker's and the server's mirror of the last global parameters (the
port's copy of the JAX package's ``util/model_cache.py``): parameter diffs
against it, and a copy on disk (``.npz``, in the JAX package's keys and
layouts) written by ``save``."""

import os

import numpy as np

from ..message import Params
from ..models.convert import to_jax


class ModelCache:
    def __init__(self) -> None:
        self._parameter_dict: Params | None = None
        self._path: str | None = None

    @property
    def parameter_dict(self) -> Params | None:
        return self._parameter_dict

    def cache_parameter_dict(self, parameter_dict: Params, path: str | None = None) -> None:
        self._parameter_dict = dict(parameter_dict)
        if path is not None:
            self._path = path

    def get_parameter_diff(self, new_parameter: Params) -> Params:
        old = self.parameter_dict
        assert old is not None
        return {k: new_parameter[k] - old[k] for k in new_parameter}

    def add_parameter_diff(self, parameter_diff: Params, path: str | None = None) -> None:
        old = self.parameter_dict
        assert old is not None
        new = {k: (v + parameter_diff[k]) if k in parameter_diff else v for k, v in old.items()}
        self.cache_parameter_dict(new, path=path)

    def save(self) -> None:
        if self._path is None or self._parameter_dict is None:
            return
        os.makedirs(os.path.dirname(os.path.abspath(self._path)), exist_ok=True)
        np.savez(self._path, **to_jax(self._parameter_dict))
