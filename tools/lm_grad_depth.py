#!/usr/bin/env python3
"""The loss and gradient norm of stablelm-3b at its published width, over
its first k layers, in the reference and in the port, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/lm_grad_depth.py [--depths 1 2 4]

Both packages take the reference's ``init_params(cfg, PRNGKey(0))``
(float32) and one structured batch of 64 tokens (``batch_at(0, seed=1)``);
the reference runs ``jax.value_and_grad(loss_fn)`` jitted, the port
``repro_torch.train.train_step.value_and_grad``. One JSON line per depth:
the two losses and the two global gradient norms. The reference's init
scales each weight by its stacked shape's second-to-last dimension, so
at published widths the gradient norm grows with depth (ROADMAP C10,
C13); this shows how fast, and that the port follows. A depth takes a
few GB of host memory and ~10 s.
"""

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as RM
from repro.train.data import batch_at
from repro.train.optim import global_norm as ref_global_norm
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.train.optim import global_norm
from repro_torch.train.train_step import value_and_grad

ARCH = "stablelm-3b"


def depth(k: int, seq: int) -> dict:
    rcfg = dataclasses.replace(ref_get_config(ARCH), n_layers=k)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=k)
    batch = batch_at(0, seed=1, global_batch=1, seq_len=seq, vocab=cfg.vocab, structured=True)
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: RM.loss_fn(rcfg, p, b)))(rp, batch)
    out = {"arch": ARCH, "layers": k, "tokens": seq, "ref_loss": float(loss),
           "ref_grad_norm": float(ref_global_norm(grads))}
    params = M.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    del rp, grads
    p_loss, p_grads = value_and_grad(cfg, params,
                                     {n: torch.from_numpy(v) for n, v in batch.items()})
    out.update(port_loss=float(p_loss), port_grad_norm=float(global_norm(p_grads)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args()
    torch.set_num_threads(4)
    for k in args.depths:
        print(json.dumps(depth(k, args.seq)), flush=True)


if __name__ == "__main__":
    main()
