"""Checkpoint / restore, in the reference's on-disk format.

Format: a directory per step, ``step-%08d/{params,opt}.npz`` plus a JSON
manifest (step, mesh shape, data-pipeline cursor, RNG key, time, the
sorted leaf keys, extra). Writes go to ``.tmp-<step>`` and are published
by an atomic rename, then ``LATEST`` names the step, so a step's failure
never corrupts the previous checkpoint. A leaf's key joins the dict keys
and list indices on its way down with '/' (``params.npz`` holds
``embed``, ``groups/0/attn0/wq``, ...; ``opt.npz`` ``step``,
``master/embed``, ``m/...``, ``v/...``).

A port of the reference's ``train/checkpoint.py``: a checkpoint that
either package writes restores in the other. Leaves are saved whole; a
restore places each leaf on its target's device and in its dtype. A
bfloat16 leaf is stored as the reference stores one (numpy has no
bfloat16): its raw 2-byte words, dtype ``V2``.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.model import tree_leaves_with_path


def _to_host(t) -> np.ndarray:
    """A copy of ``t`` on the host as numpy: the caller may go on writing
    ``t`` in place while the copy is written out."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_host(leaf) for key, leaf in tree_leaves_with_path(tree)}


def save(
    ckpt_dir: str | Path,
    step: int,
    params,
    opt_state,
    *,
    data_cursor: int = 0,
    rng_key=None,
    mesh_shape: Tuple[int, ...] = (),
    extra: Optional[Dict] = None,
    async_write: bool = False,
) -> threading.Thread | None:
    """Write checkpoint for ``step``. Every leaf is copied to the host
    before this returns; with ``async_write`` a thread writes the files
    and is returned."""
    ckpt_dir = Path(ckpt_dir)
    p_flat = _flatten(params)
    o_flat = _flatten(opt_state)
    manifest = {
        "step": int(step),
        "mesh_shape": list(mesh_shape),
        "data_cursor": int(data_cursor),
        "rng_key": np.asarray(rng_key).tolist() if rng_key is not None else None,
        "time": time.time(),
        "param_keys": sorted(p_flat),
        "opt_keys": sorted(o_flat),
        "extra": extra or {},
    }

    def write():
        tmp = ckpt_dir / f".tmp-{step}"
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / "params.npz", **p_flat)
        np.savez(tmp / "opt.npz", **o_flat)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = ckpt_dir / f"step-{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        (ckpt_dir / "LATEST").write_text(str(step))

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    f = Path(ckpt_dir) / "LATEST"
    if not f.exists():
        return None
    step = int(f.read_text().strip())
    if (Path(ckpt_dir) / f"step-{step:08d}" / "manifest.json").exists():
        return step
    # LATEST pointer ahead of a completed checkpoint (crash mid-write):
    # fall back to newest complete directory.
    steps = sorted(
        int(p.name.split("-")[1])
        for p in Path(ckpt_dir).glob("step-*")
        if (p / "manifest.json").exists()
    )
    return steps[-1] if steps else None


def _leaf_like(key: str, arr: np.ndarray, target: torch.Tensor) -> torch.Tensor:
    """``arr`` (a checkpoint leaf) as ``target``'s dtype, on its device."""
    if tuple(arr.shape) != tuple(target.shape):
        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs target "
                         f"{tuple(target.shape)}")
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bfloat16 words
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=target.device, dtype=target.dtype)


def _rebuild(flat, target, prefix=""):
    if isinstance(target, dict):
        return {k: _rebuild(flat, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in target.items()}
    if isinstance(target, list):
        return [_rebuild(flat, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(target)]
    return _leaf_like(prefix, flat[prefix], target)


def restore(
    ckpt_dir: str | Path,
    step: Optional[int] = None,
    *,
    target_params=None,
    target_opt=None,
):
    """Load a checkpoint (``step``, else the latest). With ``target_*``
    trees given, leaves are restored into the target tree's structure,
    each checked against its target's shape (``ValueError``) and cast to
    its dtype on its device (where the reference takes ``shardings``);
    without one, that part comes back as the flat dict of numpy arrays."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step-{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    p_flat = dict(np.load(d / "params.npz"))
    o_flat = dict(np.load(d / "opt.npz"))
    params = p_flat if target_params is None else _rebuild(p_flat, target_params)
    opt = o_flat if target_opt is None else _rebuild(o_flat, target_opt)
    return params, opt, manifest
