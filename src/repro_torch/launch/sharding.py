"""Sharding rules: name-pattern partition specs for parameters, optimizer
state, batches and decode caches (DESIGN.md §4).

A port of the reference's ``launch/sharding.py``, rule for rule, over the
port's trees of dicts and lists. Scheme: 2-D FSDP x TP. The
tensor-parallel ('model') axis shards heads / d_ff / experts / vocab; the
FSDP axis ('data', or ('pod', 'data') multi-pod) shards the
complementary dim of every weight. KV projections stay replicated over
'model' when kv_heads isn't divisible (GQA/MQA); the decode KV cache then
shards its *sequence* dim instead (split-KV decode). Any dim not
divisible by its axis size falls back to replication.

One card has no SPMD partitioner, so nothing here places a tensor: the
specs describe how the reference's production mesh
(``mesh.make_production_mesh``) would hold each leaf, and the dry run
(``launch/dryrun.py``) reads per-device sizes and the axes that split
each leaf from them (:class:`NamedSharding`). ``models.shardctx.constrain`` stays
the identity.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from ..configs.base import ModelConfig
from .mesh import data_axes


class PartitionSpec(tuple):
    """One entry per leading dim of a leaf: an axis name, a tuple of axis
    names (the dim split over their product), or ``None`` (replicated).
    Dims past the last entry are replicated. The reference's
    ``jax.sharding.PartitionSpec``, as a tuple."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axsize(mesh, ax) -> int:
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= mesh.shape[a]
        return n
    return mesh.shape[ax]


def _spec(mesh, shape: Tuple[int, ...], axes: Tuple) -> P:
    """PartitionSpec with divisibility fallback to replication per dim."""
    out = []
    for size, ax in zip(shape, axes):
        if ax is not None and size % _axsize(mesh, ax) == 0:
            out.append(ax)
        else:
            out.append(None)
    return P(*out)


# leaf name -> (axes per dim, by ndim excluding the leading stack dim)
def _param_axes(name: str, ndim_tail: int, dp) -> Optional[Tuple]:
    mp = "model"
    table = {
        "embed": (mp, dp),
        "lm_head": (dp, mp),
        "wq": (dp, mp, None),
        "wk": (dp, None, None),
        "wv": (dp, None, None),
        "wo": (mp, None, dp),
        "cwq": (dp, mp, None),
        "cwk": (dp, None, None),
        "cwv": (dp, None, None),
        "cwo": (mp, None, dp),
        "router": (dp, None),
        "shared_gate": (dp, mp),
        "shared_up": (dp, mp),
        "shared_down": (mp, dp),
        "w_recept": (dp, mp),
        "w_gate_in": (dp, mp),
        "w_rec_in": (dp, mp),
        "w_out": (mp, dp),
        "w_a": (dp, mp),
        "w_x": (dp, mp),
        "conv_w": (None, mp),
        "conv_b": (mp,),
        "lam": (mp,),
        "w_r": (dp, mp),
        "w_k": (dp, mp),
        "w_v": (dp, mp),
        "w_g": (dp, mp),
        "w_o": (mp, dp),
        "w_dec0": (mp,),
        "w_dec1": (dp, None),
        "w_dec2": (None, mp),
        "u": (mp,),
        "ln_w": (mp, None),
        "ln_b": (mp, None),
    }
    if name in ("w_gate", "w_up", "w_down"):
        if ndim_tail == 3:  # MoE expert-stacked [E, D, F] / [E, F, D]
            return ("model", dp, None) if name != "w_down" else ("model", None, dp)
        return (dp, "model") if name != "w_down" else ("model", dp)
    return table.get(name)


def _dp(mesh):
    dp = data_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def param_specs(cfg: ModelConfig, mesh, abstract) -> Any:
    """Spec tree matching the (abstract) param tree."""
    dp = _dp(mesh)

    def one(path, leaf):
        name = _leaf_name(path)
        stacked = _is_stacked(path)
        tail = leaf.ndim - (1 if stacked else 0)
        axes = _param_axes(name, tail, dp)
        if axes is None:
            return P()  # norms etc: replicate
        full = ((None,) + tuple(axes)) if stacked else tuple(axes)
        full = full[: leaf.ndim] + (None,) * (leaf.ndim - len(full))
        return _spec(mesh, leaf.shape, full)

    return tree_map_with_path(one, abstract)


def opt_specs(cfg: ModelConfig, mesh, abstract_opt, pspecs) -> Any:
    """Optimizer state shards exactly like its parameter (ZeRO-3)."""

    def one(path, leaf):
        if _leaf_name(path) == "step" or leaf.ndim == 0:
            return P()
        # path = opt_state[kind][...param path...]; strip the leading key
        sub = pspecs
        for k in path[1:]:
            sub = sub[k]
        return sub

    return tree_map_with_path(one, abstract_opt)


def batch_specs(mesh, abstract_batch) -> Any:
    dp = _dp(mesh)

    def one(path, leaf):
        if leaf.ndim == 0:
            return P()
        axes = (dp,) + (None,) * (leaf.ndim - 1)
        return _spec(mesh, leaf.shape, axes)

    return tree_map_with_path(one, abstract_batch)


def cache_specs(cfg: ModelConfig, mesh, abstract_cache) -> Any:
    """KV cache: batch over FSDP axis; heads over 'model' when divisible,
    otherwise the sequence dim (split-KV decode). Recurrent states shard
    their channel dim over 'model'."""
    dp = _dp(mesh)
    mp = "model"
    kv_div = cfg.n_kv_heads % _axsize(mesh, mp) == 0

    def one(path, leaf):
        name = _leaf_name(path)
        if name in ("k", "v", "ck", "cv"):  # [n, B, T, KV, dh]
            axes = (None, dp, None, mp, None) if kv_div else (None, dp, mp, None, None)
        elif name == "pos":
            axes = (None, None)
        elif name == "S":  # [n, B, H, dh, dh]
            axes = (None, dp, mp, None, None)
        elif name == "h":  # [n, B, R]
            axes = (None, dp, mp)
        elif name == "conv":  # [n, B, W-1, R]
            axes = (None, dp, None, mp)
        elif name == "x_prev":  # [n, B, D]
            axes = (None, dp, None)
        else:
            axes = (None,) * leaf.ndim
        return _spec(mesh, leaf.shape, axes)

    return tree_map_with_path(one, abstract_cache)


def act_spec(cfg: ModelConfig, mesh, seq_len: int) -> Optional[P]:
    """Residual-stream constraint between layers: sequence-sharded over
    'model' (Megatron sequence parallelism) when divisible."""
    if not cfg.seq_shard_activations:
        return None
    dp = _dp(mesh)
    if seq_len % _axsize(mesh, "model") != 0:
        return P(dp, None, None)
    return P(dp, "model", None)


class NamedSharding:
    """A leaf's spec on a mesh: the axes that split each dim, and the
    shape one device holds. The reference's ``jax.sharding.NamedSharding``
    where the dry run reads it; it places nothing."""

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, spec

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes that split ``dim`` (none past the spec's end)."""
        entry = self.spec[dim] if dim < len(self.spec) else None
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    def shards_over(self, names) -> int:
        """How many ways the spec splits a leaf over the mesh axes ``names``."""
        n = 1
        for dim in range(len(self.spec)):
            for a in self.axes(dim):
                if a in names:
                    n *= self.mesh.shape[a]
        return n

    def shard_shape(self, global_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """The per-device shape of a leaf of ``global_shape``; raises where
        a sharded dim does not divide, as JAX does."""
        if len(self.spec) > len(global_shape):
            raise ValueError(f"spec {self.spec} has more entries than shape {global_shape}")
        out = []
        for dim, size in enumerate(global_shape):
            n = _axsize(self.mesh, self.axes(dim))
            if size % n:
                raise ValueError(f"dim {dim} of {tuple(global_shape)} does not divide into {n} "
                                 f"shards of {self.spec}")
            out.append(size // n)
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def to_shardings(mesh, spec_tree) -> Any:
    return tree_map_with_path(lambda _, s: NamedSharding(mesh, s), spec_tree)


# -- tree helpers ------------------------------------------------------------


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts and lists, same nesting; a
    path is the tuple of dict keys and list indices down to the leaf. A
    ``PartitionSpec`` (a tuple) is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _leaf_name(path) -> str:
    for k in reversed(path):
        if isinstance(k, str):
            return k
    return ""


def _is_stacked(path) -> bool:
    return any(k in ("groups", "enc_groups") for k in path if isinstance(k, str))
