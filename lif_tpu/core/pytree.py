"""Frozen dataclasses registered as JAX pytrees.

Fields are pytree leaves unless declared with `static_field()`; static
fields are part of the treedef (hashable metadata, jit-static). Instances
get a `replace(**changes)` method.
"""

from __future__ import annotations

import dataclasses

import jax

__all__ = ["pytree_dataclass", "static_field"]


def static_field(**kwargs):
    """A dataclass field carried as pytree metadata, not as a leaf."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def pytree_dataclass(cls):
    """Make `cls` a frozen dataclass and register it as a pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    fields = dataclasses.fields(cls)
    return jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
