"""HLO text of JAX programs compiled at 4 forced host devices, for the
port's dry-run tests (``test_torch_dryrun.py``), which run this file in a
process of its own: JAX fixes its device count when it first starts.

  XLA_FLAGS=--xla_force_host_platform_device_count=4 PYTHONPATH=src JAX_PLATFORMS=cpu \
      python tests/_xla_programs.py OUT.json '[["stablelm-3b", "train", 256, 8]]'
  XLA_FLAGS=--xla_force_host_platform_device_count=4 PYTHONPATH=src JAX_PLATFORMS=cpu \
      python tests/_xla_programs.py --table

The first form writes {name: HLO text} to OUT.json: three small programs
that hold every collective kind, and the reference's smoke steps (arch,
kind, seq_len, global_batch) as its dry run builds them, on a 2 x 2
('data', 'model') mesh. The second prints, for the smoke steps of every
architecture, the port's collective model (``repro_torch.launch.dryrun.
collective_model``) over XLA's bytes a device, by kind, as the reference's
analyzer reads them (about 3 min).
"""

import json
import re
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import ARCHS, smoke_config
from repro.launch import sharding as SH
from repro.models import model as M
from repro.models.shardctx import set_shard_hints
from repro.train.optim import abstract_opt_state
from repro.train.train_step import make_train_step


def collective_programs() -> dict:
    mesh = jax.make_mesh((2, 2), ("data", "model"))

    def sh(*s):
        return NamedSharding(mesh, P(*s))

    x = jnp.ones((8, 64), jnp.float32)
    w = jnp.ones((64, 32), jnp.float32)
    out = {}
    # contraction over 'model': an all-reduce; the replicated result of a
    # data-sharded input: an all-gather
    out["reduce_gather"] = jax.jit(
        lambda x, w: jnp.tanh(x @ w), in_shardings=(sh("data", "model"), sh("model", None)),
        out_shardings=sh()).lower(x, w).compile().as_text()

    def scanned(w, x):
        def body(c, _):
            return jnp.tanh(c @ w), None

        y, _ = jax.lax.scan(body, x, None, length=5)
        return y

    out["scan"] = jax.jit(scanned, in_shardings=(sh("model", None), sh("data", "model")),
                          out_shardings=sh("data", None)).lower(jnp.ones((64, 64)), x
                                                                 ).compile().as_text()
    from jax.experimental.shard_map import shard_map

    def local(a):
        b = jax.lax.psum_scatter(a, "model", scatter_dimension=1, tiled=True)
        c = jax.lax.all_to_all(a, "data", 0, 0, tiled=True)
        d = jax.lax.ppermute(a, "model", perm=[(0, 1), (1, 0)])
        return b.sum() + c.sum() + d.sum()

    f = shard_map(local, mesh=mesh, in_specs=P("data", "model"), out_specs=P(), check_rep=False)
    out["scatter_all_to_all_permute"] = jax.jit(f).lower(jnp.ones((8, 64))).compile().as_text()
    return out


def step_text(arch: str, kind: str, S: int, B: int) -> str:
    """The reference's smoke step as its dry run builds it, on a mesh of
    automatic axes (``with_sharding_constraint`` refuses explicit ones),
    in float32: XLA on the CPU moves bf16 weights as float32."""
    auto = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    set_shard_hints(auto)

    def to(specs):
        return SH.to_shardings(auto, specs)

    cfg = smoke_config(arch)
    ap = M.abstract_params(cfg, jnp.float32)
    ps = SH.param_specs(cfg, auto, ap)
    batch = M.input_specs(cfg, {"kind": kind, "seq_len": S, "global_batch": B}, jnp.float32)
    bs = to(SH.batch_specs(auto, batch))
    with auto:
        if kind == "train":
            ao = abstract_opt_state(ap, cfg.optimizer)
            os_ = to(SH.opt_specs(cfg, auto, ao, ps))
            step = make_train_step(cfg, act_spec=SH.act_spec(cfg, auto, S))
            low = jax.jit(step, in_shardings=(to(ps), os_, bs),
                          out_shardings=(to(ps), os_, None)).lower(ap, ao, batch)
        elif kind == "prefill":
            fn = partial(M.prefill, cfg, act_spec=SH.act_spec(cfg, auto, S))
            low = jax.jit(fn, in_shardings=(to(ps), bs)).lower(ap, batch)
        else:
            ac = M.abstract_cache(cfg, B, S)
            cs = to(SH.cache_specs(cfg, auto, ac))

            def fn(p, c, b):
                return M.decode_step(cfg, p, c, b["token"], b["pos"])

            low = jax.jit(fn, in_shardings=(to(ps), cs, bs),
                          out_shardings=(None, cs)).lower(ap, ac, batch)
    return low.compile().as_text()


def renamed(text: str) -> str:
    """HLO text with each value named after a collective renamed. The
    reference's analyzer and ``parse_collectives`` take the first
    collective word of a line for its opcode, so they count an
    instruction that reads a collective's result
    (``bitcast(%all-gather.54)``) as one more collective."""
    return re.sub(r"%(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)",
                  lambda m: "%" + m.group(1).replace("-", "_"), text)


def model_traffic(arch: str, kind: str, S: int, B: int) -> dict:
    """The port's collective model of the same step, float32, 2 x 2."""
    import torch

    from repro_torch.configs import smoke_config as port_smoke_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import sharding as PSH
    from repro_torch.launch.mesh import ProductionMesh
    from repro_torch.models import model as PM

    cfg = port_smoke_config(arch)
    mesh = ProductionMesh((2, 2), ("data", "model"))
    params = PM.abstract_params(cfg, torch.float32)
    traffic, _, _ = D.collective_model(cfg, {"kind": kind, "seq_len": S, "global_batch": B},
                                       mesh, params, PSH.param_specs(cfg, mesh, params))
    return traffic


def table() -> None:
    from repro.launch.hlo_analysis import analyze

    print("| arch | step | XLA bytes/device | model / XLA | all-gather | all-reduce | "
          "XLA's other kinds | phantom share |")
    print("|---|---|---|---|---|---|---|---|")
    for arch in ARCHS:
        for kind, S, B in (("train", 256, 8), ("train", 4096, 16), ("prefill", 256, 8),
                           ("prefill", 4096, 16), ("decode", 256, 8)):
            text = step_text(arch, kind, S, B)
            xla = analyze(renamed(text)).coll_bytes
            raw = sum(analyze(text).coll_bytes.values())
            got = model_traffic(arch, kind, S, B)
            total = sum(xla.values())

            def ratio(k):
                return f"{got.get(k, 0.0) / xla[k]:.3f}" if xla.get(k) else "-"

            other = {k: v for k, v in xla.items() if k not in ("all-gather", "all-reduce")}
            print(f"| {arch} | {kind} {S}x{B} | {total:.0f} | {sum(got.values()) / total:.3f} | "
                  f"{ratio('all-gather')} | {ratio('all-reduce')} | "
                  f"{', '.join(f'{k} {v:.0f}' for k, v in sorted(other.items())) or '-'} | "
                  f"{(raw - total) / raw:.3f} |", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--table":
        table()
    else:
        texts = collective_programs()
        for arch, kind, S, B in json.loads(sys.argv[2]):
            texts[f"step:{arch}:{kind}:{S}x{B}"] = step_text(arch, kind, S, B)
        with open(sys.argv[1], "w") as f:
            json.dump(texts, f)
