# Copied from src/repro/core/registry.py.
"""Tiny name → factory registries backing the declarative experiment API.

A :class:`Registry` is a dict with manners: registration can be guarded
against silent overwrites, lookups of unknown names raise a precise error
listing what *is* registered, and ``register`` doubles as a decorator.
The port's registries are ``repro_torch.core.samplers.SAMPLERS``
(client-selection schemes), ``repro_torch.fl.engine.ENGINES`` (round
execution engines), ``repro_torch.fl.experiment.DATASETS`` (partitions),
``repro_torch.kernels.sketch.SKETCHERS`` (the gradient store's sketch stage),
``repro_torch.core.clustering.backends.CLUSTERERS`` and
``repro_torch.fl.population.POPULATIONS`` (client churn); the spec layer
(``repro_torch.fl.experiment``) resolves every name through them, so
extending the port is ``register_sampler("mine", MySampler)`` plus a spec
dict.
"""
from __future__ import annotations

import difflib
from typing import Any, Callable, Iterator, Optional


class Registry:
    """Mapping from names to factories with precise unknown-name errors."""

    def __init__(self, kind: str, initial: Optional[dict] = None):
        self.kind = kind
        self._entries: dict[str, Any] = dict(initial or {})

    # -- registration -------------------------------------------------------
    def register(
        self, name: str, factory: Any = None, *, override: bool = False
    ) -> Callable:
        """Register ``factory`` under ``name``; decorator form when omitted.

        Re-registering an existing name is an error unless ``override=True``
        — sweeps that monkey-register variants must say so explicitly.
        """
        if factory is None:
            return lambda f: self.register(name, f, override=override)
        if name in self._entries and not override:
            raise ValueError(
                f"{self.kind} {name!r} is already registered "
                f"(pass override=True to replace it)"
            )
        self._entries[name] = factory
        return factory

    def unregister(self, name: str) -> None:
        if name not in self._entries:
            raise ValueError(self._unknown(name))
        del self._entries[name]

    # -- lookup -------------------------------------------------------------
    def get(self, name: str) -> Any:
        try:
            return self._entries[name]
        except KeyError:
            raise ValueError(self._unknown(name)) from None

    def _unknown(self, name: str) -> str:
        msg = (
            f"unknown {self.kind} {name!r}; registered {self.kind}s: "
            f"{sorted(self._entries)}"
        )
        close = difflib.get_close_matches(str(name), list(self._entries), n=1)
        if close:
            msg += f" — did you mean {close[0]!r}?"
        return msg

    def names(self) -> list[str]:
        return sorted(self._entries)

    # -- dict-ish surface (existing ``SAMPLERS["md"]`` call sites) ----------
    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def items(self):
        return self._entries.items()

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}, {sorted(self._entries)})"
