"""Training driver.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b --smoke \
      --steps 50 --ckpt-dir build/ckpt [--device cpu]

A port of the reference's ``launch/train.py``: draw the parameters on
``--device`` (the CUDA card unless asked for the CPU) from ``--seed``,
restore from ``--ckpt-dir`` if it holds a checkpoint, stream the
deterministic data pipeline, checkpoint every ``--ckpt-every`` steps
(async, atomic) and at the end. ``--smoke`` takes the reduced same-family
config; otherwise the published one. The mesh is the one-shard
``DataMesh`` (recorded as ``mesh_shape`` (1, 1), as the reference records
its smoke mesh); ``--production-mesh`` asks for the reference's 16 x 16
mesh of 256 devices and raises here, as ``jax.make_mesh`` does on fewer.
The step runs eagerly (the reference jits it and donates the state; the
port updates the state in place instead).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, smoke_config
from ..models import model as M
from ..models.shardctx import set_shard_hints
from ..train import checkpoint as CKPT
from ..train.data import Pipeline
from ..train.optim import init_opt_state
from ..train.train_step import make_train_step
from .mesh import make_smoke_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--structured-data", action="store_true", default=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = M.resolve_device(args.device)
    if args.production_mesh:
        have = torch.cuda.device_count() if dev.type == "cuda" else 1
        raise RuntimeError(
            f"the production mesh (16, 16) needs 256 devices with a 'model' axis; {have} "
            f"{dev.type} device(s) visible, and the port's DataMesh has a 'data' axis only"
        )
    mesh = make_smoke_mesh(args.device)
    set_shard_hints(mesh)
    mesh_shape = np.asarray(mesh.devices, dtype=object).shape
    # the reference's PRNGKey(seed) for a seed below 2**32, recorded in the manifest
    key = np.array([0, args.seed], dtype=np.uint32)

    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    opt = init_opt_state(params, cfg.optimizer)

    start_step = 0
    if args.ckpt_dir and CKPT.latest_step(args.ckpt_dir) is not None:
        params, opt, manifest = CKPT.restore(args.ckpt_dir, target_params=params, target_opt=opt)
        start_step = manifest["step"]
        print(f"restored step {start_step} from {args.ckpt_dir} "
              f"(mesh was {manifest['mesh_shape']})")

    step_fn = make_train_step(cfg, act_spec=None, n_microbatches=args.microbatches, lr=args.lr,
                              device=dev)
    pipe = Pipeline(
        args.seed + 1, args.batch, args.seq, cfg.vocab, start_step=start_step,
        structured=args.structured_data,
    )
    t0 = time.time()
    writer = None
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        if step % 10 == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            print(
                f"step {step:5d} loss {loss:8.4f} |grad| {gn:8.3f} "
                f"({(time.time()-t0)/(step-start_step+1):.2f}s/step)",
                flush=True,
            )
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            if writer is not None:
                writer.join()
            writer = CKPT.save(
                args.ckpt_dir, step + 1, params, opt, data_cursor=pipe.cursor, rng_key=key,
                mesh_shape=mesh_shape, async_write=True,
            )
    if writer is not None:
        writer.join()
    if args.ckpt_dir:
        CKPT.save(
            args.ckpt_dir, args.steps, params, opt, data_cursor=pipe.cursor, rng_key=key,
            mesh_shape=mesh_shape,
        )
    return params, opt


if __name__ == "__main__":
    main()
