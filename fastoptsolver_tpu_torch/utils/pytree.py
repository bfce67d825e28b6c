"""Frozen dataclasses as torch pytree nodes, the counterpart of
``jax.tree_util.register_dataclass``: the children are the data fields in
declaration order, so a flattened state lists its leaves in the order the
JAX package's does (what :mod:`.checkpoint` relies on to read either
package's files); the named static fields ride in the tree's context."""
from __future__ import annotations

import dataclasses

import torch.utils._pytree as _pytree


def register_dataclass(cls=None, *, static: tuple[str, ...] = ()):
    """Register the frozen dataclass ``cls`` (usable as a decorator, with or
    without ``static=``); returns ``cls``."""
    def register(cls):
        data = tuple(f.name for f in dataclasses.fields(cls) if f.name not in static)

        def flatten(obj):
            return ([getattr(obj, f) for f in data],
                    tuple(getattr(obj, f) for f in static))

        def unflatten(children, context):
            return cls(**dict(zip(data, children)), **dict(zip(static, context)))

        _pytree.register_pytree_node(
            cls, flatten, unflatten,
            serialized_type_name=f"{cls.__module__}.{cls.__qualname__}")
        return cls

    return register if cls is None else register(cls)
