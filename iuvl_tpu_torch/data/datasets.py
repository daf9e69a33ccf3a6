"""The dataset registry, port of the registry of ``iuvl_tpu/data/datasets.py``:
a name -> constructor table filled at import, and ``build_dataset``, which
resolves a requested name onto a registered one the way JAX's does (the
first registered name that the request starts with or contains). Only the
stage-2 instruction streams are registered (``vlp_datasets.py``); the other
loaders are not ported yet."""

from __future__ import annotations

from typing import Callable

DATASET_REGISTRY: dict[str, Callable] = {}


def register_dataset(name: str):
    def deco(fn):
        DATASET_REGISTRY[name] = fn
        return fn

    return deco


def build_dataset(name: str, cfg: dict | None = None, split: str = "train"):
    """The dataset of the first registered name that ``name`` starts with or
    contains, built from ``cfg``."""
    for key, build in DATASET_REGISTRY.items():
        if name.startswith(key) or key in name:
            return build(cfg or {}, split)
    raise KeyError(f"dataset {name!r} not registered; have {list(DATASET_REGISTRY)}")


from . import vlp_datasets  # noqa: E402,F401  (fills the registry)
