"""HLO text of JAX programs compiled at 4 forced host devices, for the
port's dry-run tests (``test_torch_dryrun.py``), which run this file in a
process of its own: JAX fixes its device count when it first starts.

  XLA_FLAGS=--xla_force_host_platform_device_count=4 PYTHONPATH=src JAX_PLATFORMS=cpu \
      python tests/_xla_programs.py OUT.json '[["stablelm-3b", "train", 256, 8]]'
  XLA_FLAGS=--xla_force_host_platform_device_count=4 PYTHONPATH=src JAX_PLATFORMS=cpu \
      python tests/_xla_programs.py --table [--mesh 2x2] [--arch rwkv6-7b,...] \
          [--steps train:256x8,decode:256x1] [--widths '{"vocab": 8192}']

The first form writes {name: HLO text} to OUT.json (names of
``step_key``): three small programs that hold every collective kind, and
the reference's smoke steps (arch, kind, seq_len, global_batch[, mesh
dims[, fields to replace]]) as its dry run builds them, on a 2 x 2
('data', 'model') mesh or the dims given (as many forced host devices at
least). The second prints, for the smoke steps of every
architecture (or those of ``--arch``; ``--steps`` for others, ``--widths``
to replace config fields), the port's collective model
(``repro_torch.launch.dryrun.collective_model``) over XLA's bytes a
device, by kind, as the reference's analyzer reads them, the share of
XLA's bytes in kinds the model lacks, and whether ``check_model``'s rule
is met (about 3 min), on a 2 x 2 mesh or the ``--mesh`` given (as many
forced host devices at least).
"""

import argparse
import dataclasses
import json
import math
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
    mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])

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


#: (kind, seq_len, global_batch) of the smoke steps each architecture is
#: held to
STEPS = (("train", 256, 8), ("train", 4096, 16), ("prefill", 256, 8), ("prefill", 4096, 16),
         ("decode", 256, 8))


def step_key(arch: str, kind: str, S: int, B: int, dims=(2, 2), widths=None) -> str:
    """The name of a step's program in the JSON the first form writes."""
    key = f"step:{arch}:{kind}:{S}x{B}"
    if tuple(dims) != (2, 2):
        key += f":{dims[0]}x{dims[1]}"
    if widths:
        key += ":" + ",".join(f"{k}={v}" for k, v in sorted(widths.items()))
    return key


def with_widths(cfg, widths=None):
    """``cfg`` with the fields of ``widths`` replaced (e.g. ``d_model``,
    ``lru_dim``), so that tensors whose smoke shapes coincide differ;
    ``n_experts`` replaces the MoE's field of that name (where there is an
    MoE)."""
    if not widths:
        return cfg
    widths = dict(widths)
    experts = widths.pop("n_experts", None)
    if experts and cfg.moe is not None:
        widths["moe"] = dataclasses.replace(cfg.moe, n_experts=experts)
    new = dataclasses.replace(cfg, **widths)
    new.__post_init__()
    return new


def step_text(arch: str, kind: str, S: int, B: int, dims=(2, 2), widths=None) -> str:
    """The reference's smoke step (its fields ``widths`` replaced) as its
    dry run builds it, on a ('data', 'model') mesh of ``dims`` and
    automatic axes (``with_sharding_constraint`` refuses explicit ones),
    in float32: XLA on the CPU moves bf16 weights as float32."""
    auto = jax.sharding.Mesh(np.array(jax.devices()[: math.prod(dims)]).reshape(dims),
                             ("data", "model"))
    set_shard_hints(auto)

    def to(specs):
        return SH.to_shardings(auto, specs)

    cfg = with_widths(smoke_config(arch), widths)
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


def model_traffic(arch: str, kind: str, S: int, B: int, dims=(2, 2), widths=None) -> dict:
    """The port's collective model of the same step, float32."""
    import torch

    from repro_torch.configs import smoke_config as port_smoke_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import sharding as PSH
    from repro_torch.launch.mesh import ProductionMesh
    from repro_torch.models import model as PM

    cfg = with_widths(port_smoke_config(arch), widths)
    mesh = ProductionMesh(dims, ("data", "model"))
    params = PM.abstract_params(cfg, torch.float32)
    traffic, _, _ = D.collective_model(cfg, {"kind": kind, "seq_len": S, "global_batch": B},
                                       mesh, params, PSH.param_specs(cfg, mesh, params))
    return traffic


def check_model(kind: str, traffic: dict, xla: dict) -> None:
    """The rule that holds the collective model's ``traffic`` to XLA's
    bytes a device: the total within 10%, each kind the model has within
    10% (decode's all-reduces, a few KB of row outputs and combines,
    within 25%), the kinds it lacks under 3% of XLA's total."""
    total = sum(xla.values())
    assert abs(sum(traffic.values()) / total - 1) < 0.10, (traffic, xla)
    for k, v in traffic.items():
        tol = 0.25 if (kind, k) == ("decode", "all-reduce") else 0.10
        assert abs(v / xla[k] - 1) < tol, (k, traffic, xla)
    assert sum(v for k, v in xla.items() if k not in traffic) < 0.03 * total, xla


def table(archs, dims, steps=STEPS, widths=None) -> None:
    from repro.launch.hlo_analysis import analyze

    kinds = ("all-gather", "all-reduce", "all-to-all", "collective-permute")
    print(f"mesh {dims[0]}x{dims[1]}" + (f", widths {widths}" if widths else ""))
    print("| arch | step | XLA bytes/device | model / XLA | " + " | ".join(kinds)
          + " | XLA's other kinds | lacked share | phantom share | rule |")
    print("|---|---|---|---|" + "---|" * len(kinds) + "---|---|---|---|")
    for arch in archs:
        for kind, S, B in steps:
            text = step_text(arch, kind, S, B, dims, widths)
            xla = analyze(renamed(text)).coll_bytes
            raw = sum(analyze(text).coll_bytes.values())
            got = model_traffic(arch, kind, S, B, dims, widths)
            total = sum(xla.values())
            try:
                check_model(kind, got, xla)
                rule = "met"
            except AssertionError:
                rule = "missed"

            def ratio(k):
                return f"{got.get(k, 0.0) / xla[k]:.3f}" if xla.get(k) else "-"

            other = {k: v for k, v in xla.items() if k not in kinds}
            lacked = sum(v for k, v in xla.items() if k not in got) / total
            print(f"| {arch} | {kind} {S}x{B} | {total:.0f} | {sum(got.values()) / total:.3f} | "
                  + " | ".join(ratio(k) for k in kinds) + " | "
                  f"{', '.join(f'{k} {v:.0f}' for k, v in sorted(other.items())) or '-'} | "
                  f"{lacked:.3f} | {(raw - total) / raw:.3f} | {rule} |", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--table":
        ap = argparse.ArgumentParser()
        ap.add_argument("--table", action="store_true")
        ap.add_argument("--mesh", default="2x2")
        ap.add_argument("--arch", default=",".join(ARCHS))
        ap.add_argument("--steps", default=None,
                        help="kind:SxB,... (default: the five of STEPS)")
        ap.add_argument("--widths", default=None, help="JSON of config fields to replace")
        args = ap.parse_args()
        steps = STEPS if args.steps is None else [
            (kind, *map(int, sb.split("x"))) for kind, sb in
            (step.split(":") for step in args.steps.split(","))]
        table(args.arch.split(","), tuple(int(n) for n in args.mesh.split("x")), steps,
              json.loads(args.widths) if args.widths else None)
    else:
        texts = collective_programs()
        for arch, kind, S, B, *opts in json.loads(sys.argv[2]):
            dims, widths = (tuple(opts[0]) if opts else (2, 2)), (opts[1] if opts[1:] else None)
            texts[step_key(arch, kind, S, B, dims, widths)] = step_text(arch, kind, S, B, dims,
                                                                         widths)
        with open(sys.argv[1], "w") as f:
            json.dump(texts, f)
