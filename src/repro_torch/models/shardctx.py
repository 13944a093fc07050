"""Sharding-hint context, kept with the reference's signatures.

The reference's layers call ``constrain(x, 'dp', None, 'mp', ...)`` to
place GSPMD sharding constraints on large intermediates once a driver has
called ``set_shard_hints(mesh)``. One card has no GSPMD, so here
``constrain`` returns ``x`` unchanged, with or without hints: the port's
models compute on whole tensors. ``set_shard_hints`` records the mesh it
is given in ``_HINTS`` and places nothing.
"""

from __future__ import annotations

_HINTS = {"mesh": None}


def set_shard_hints(mesh) -> None:
    _HINTS["mesh"] = mesh


def clear_shard_hints() -> None:
    set_shard_hints(None)


def constrain(x, *axes):
    """axes: 'dp' | 'mp' | None per dim. Returns ``x`` itself."""
    return x
