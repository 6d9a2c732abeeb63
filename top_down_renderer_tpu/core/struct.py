"""Frozen dataclasses registered as JAX pytrees.

`dataclass` makes a frozen dataclass whose fields are pytree children,
except those declared with `field(pytree_node=False)`, which become
static metadata (part of the jit cache key).  `replace(**updates)`
returns a copy with some fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    return dataclasses.field(
        metadata={"pytree_node": pytree_node}, **kwargs
    )


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[
            f.name for f in fields if f.metadata.get("pytree_node", True)
        ],
        meta_fields=[
            f.name
            for f in fields
            if not f.metadata.get("pytree_node", True)
        ],
    )
    cls.replace = lambda self, **updates: dataclasses.replace(
        self, **updates
    )
    return cls
