"""Minimal global registry: name -> class/function maps by kind (the
counterpart of ``rlcf_tpu/utils/registry.py``; the LAVIS ``Registry``
pattern, `retrieval/lavis/common/registry.py:9-329`)."""

from __future__ import annotations

from typing import Callable, Dict


class Registry:
    _stores: Dict[str, Dict[str, Callable]] = {}

    @classmethod
    def register(cls, kind: str, name: str):
        store = cls._stores.setdefault(kind, {})

        def deco(obj):
            if name in store:
                raise KeyError(f"{kind}:{name} already registered")
            store[name] = obj
            return obj

        return deco

    @classmethod
    def get(cls, kind: str, name: str):
        try:
            return cls._stores[kind][name]
        except KeyError:
            known = sorted(cls._stores.get(kind, {}))
            raise KeyError(f"unknown {kind} {name!r}; known: {known}") from None

    @classmethod
    def list(cls, kind: str):
        return sorted(cls._stores.get(kind, {}))
