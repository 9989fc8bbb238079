"""RuntimeContext + LocalStorage for "rich" user functions.

Re-design of reference ``wf/context.hpp`` (:49-102) and
``wf/local_storage.hpp`` (get :68-83, put :92-108, remove :116-124).
A rich callable receives the replica's parallelism, its index, and a
typed per-replica key-value store with default-construct-on-get.
"""
from __future__ import annotations

from typing import Any, Callable, Dict


class LocalStorage:
    __slots__ = ("_store",)

    def __init__(self):
        self._store: Dict[str, Any] = {}

    def get(self, name: str, factory: Callable[[], Any] = None) -> Any:
        """Return the value under ``name``; if absent and a factory is
        given, default-construct it first (local_storage.hpp:68-83)."""
        if name not in self._store and factory is not None:
            self._store[name] = factory()
        return self._store.get(name)

    def put(self, name: str, value: Any) -> None:
        self._store[name] = value

    def remove(self, name: str) -> None:
        self._store.pop(name, None)

    def is_contained(self, name: str) -> bool:
        return name in self._store

    def __len__(self) -> int:
        return len(self._store)


class RuntimeContext:
    __slots__ = ("parallelism", "replica_index", "storage")

    def __init__(self, parallelism: int = 1, replica_index: int = 0):
        self.parallelism = parallelism
        self.replica_index = replica_index
        self.storage = LocalStorage()

    def get_parallelism(self) -> int:
        return self.parallelism

    def get_replica_index(self) -> int:
        return self.replica_index

    def get_local_storage(self) -> LocalStorage:
        return self.storage
