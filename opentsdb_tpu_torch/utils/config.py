"""Flat ``tsd.*`` configuration (ref: ``src/utils/Config.java``).

A flat string->string property map with typed getters and defaults,
holding only the keys the PyTorch port reads. Keys keep the
reference's ``tsd.`` namespace; port-specific keys live under
``tsd.torch.*``.
"""

from __future__ import annotations

from typing import Any

_DEFAULTS: dict[str, str] = {
    "tsd.core.auto_create_metrics": "false",
    "tsd.core.auto_create_tagks": "true",
    "tsd.core.auto_create_tagvs": "true",
    "tsd.mode": "rw",  # rw | ro | wo (ref: TSDB.java:103)
    "tsd.storage.uid.width.metric": "3",
    "tsd.storage.uid.width.tagk": "3",
    "tsd.storage.uid.width.tagv": "3",
    # where the query compute runs: "cuda" (default; raises when no
    # card is present) or "cpu" (the plain-PyTorch versions of every
    # kernel — the test configuration)
    "tsd.torch.device": "cuda",
    # compute dtype of the query pipeline: float32, or float64 on
    # request (the CUDA kernels are float32-only; float64 runs the
    # dense PyTorch path)
    "tsd.torch.dtype": "float32",
    # The engine serves the point path only. These four keys name the
    # paths of the reference engine that the port does not have yet;
    # their defaults select the point path and any other value raises
    # NotImplementedError when the engine is built.
    "tsd.query.grid_reduce": "false",
    "tsd.query.device_cache_mb": "0",
    "tsd.query.host_tail_max_cells": "-1",
    "tsd.query.host_tail_max_cells_linear": "-1",
}


class Config:
    """(ref: src/utils/Config.java:52)"""

    def __init__(self, **overrides: Any):
        self._props: dict[str, str] = dict(_DEFAULTS)
        for key, val in overrides.items():
            self._props[key.replace("__", ".")] = str(val)

    def get_string(self, key: str, default: str | None = None) -> str:
        if key in self._props:
            return self._props[key]
        if default is not None:
            return default
        raise KeyError(key)

    def get_int(self, key: str, default: int | None = None) -> int:
        try:
            return int(self._props[key])
        except KeyError:
            if default is not None:
                return default
            raise

    def get_bool(self, key: str, default: bool = False) -> bool:
        val = self._props.get(key)
        if val is None:
            return default
        return val.strip().lower() in ("true", "1", "yes")
