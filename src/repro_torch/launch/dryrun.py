"""Multi-pod dry run: count every (architecture x input shape) on the
production meshes and record its per-device compute, memory and
collective statistics.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b --shape train_4k --multi-pod both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --db-plane

A port of the reference's ``launch/dryrun.py``, with its CLI, its
resumable results file and its record keys. The reference lowers and
compiles each cell under ``NamedSharding``s on 256 or 512 forced host
devices and reads XLA's analyses and compiled HLO. The port has no such
compiler, so:

* **No devices.** Parameters, optimizer state, batch and cache are
  ``meta`` tensors (``abstract_params``, ``abstract_opt_state``,
  ``input_specs``, ``abstract_cache``), and the step (the train step,
  prefill, or one decode step at position ``seq_len - 1``) runs on them
  under ``hlo_analysis.OpCounter``, which counts FLOPs and unfused HBM
  bytes of the global program. Each layer group is counted at one
  repetition and at two, and the count extrapolated to the model's
  depth (:func:`count_cell`): exact, since the repetitions are
  shape-identical, and the counterpart of the analyzer's loop trips.
* **Per device by division.** ``flops_per_device`` and
  ``mem_bytes_per_device`` are the global counts over the mesh's
  devices: compute that the specs' divisibility fallbacks replicate is
  not in them. The global count does not depend on the mesh, so ``main``
  counts each (arch, shape) once for both meshes.
* **Collectives modelled from the specs** (:func:`collective_model`),
  not read from a compiled program.
* ``analytic_bytes_per_device`` is the reference's formula over the
  port's specs (``sharding``): exact. ``memory_analysis`` is
  "unavailable", as the reference records it where the backend has none;
  ``cost_analysis`` holds the global counted ``flops`` and
  ``bytes accessed``; ``hlo_bytes`` is None (no HLO text); ``lower_s``
  is the seconds taken to build the abstract trees and specs,
  ``compile_s`` those of the count.

Results go to benchmarks/results/dryrun_torch.json, a file of the port's
own, so that the reference's records are never overwritten. A cell that
cannot run on ``meta`` (an op that reads a value) is recorded with
``status: fail`` and its error, as the reference records its failures.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from ..configs import SHAPES, cells, get_config
from ..models import model as M
from ..models.layers import QCHUNK, QCHUNK_THRESHOLD
from ..train.optim import abstract_opt_state
from ..train.train_step import make_train_step
from . import sharding as SH
from .hlo_analysis import OpCounter, _coll_traffic
from .mesh import DataMesh, data_axes, make_production_mesh

RESULTS = Path(__file__).resolve().parents[3] / "benchmarks" / "results" / "dryrun_torch.json"

#: the loss's chunk of tokens (``models.model.loss_fn``)
LOSS_CHUNK = 1024

#: products whose weight's contracted input dim ('model'-sharded heads,
#: d_ff, recurrence or RWKV channels) leaves a partial sum per 'model'
#: shard, and whose output dim is split over the data axes. Values: the
#: contracted dims of the leaf (without the stack dim), by its rank.
ROW_PARALLEL = {
    "wo": {3: (0, 1)},
    "cwo": {3: (0, 1)},
    "w_down": {2: (0,), 3: (1,)},
    "shared_down": {2: (0,)},
    "w_out": {2: (0,)},
    "w_o": {2: (0,)},
}

#: the recurrent blocks' products whose input a sequence-split step gathers
#: whole over 'model' (``_rwkv_terms``, ``_rg_lru_terms``): the
#: RG-LRU gates in every pass (so only their 'model' shard is gathered),
#: the RWKV chunk scan's projections (and the decay LoRA's second product)
#: and the recurrence's input projection in the backward (where their
#: 'model' shard is gathered once more). Their gradient is a 'model' shard's,
#: reduced over the data axes only.
GATHERED_INPUT_FWD = ("w_a", "w_x")
GATHERED_INPUT_BWD = ("w_r", "w_k", "w_v", "w_rec_in")
GATHERED_INPUT = GATHERED_INPUT_FWD + GATHERED_INPUT_BWD + ("w_dec2",)


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _n_data(mesh) -> int:
    return SH._axsize(mesh, data_axes(mesh))


def tree_bytes_per_device(abstract, specs, mesh) -> float:
    """Analytic bytes/device of a tree given its specs (the reference's
    ``_tree_bytes_per_device``)."""
    total = 0.0
    for (_, a), (_, sh) in zip(M.tree_leaves_with_path(abstract),
                               M.tree_leaves_with_path(SH.to_shardings(mesh, specs))):
        total += math.prod(sh.shard_shape(tuple(a.shape))) * a.element_size()
    return total


# ---------------------------------------------------------------------------
# The global count
# ---------------------------------------------------------------------------


def _abstract_inputs(cfg, shape):
    """(params, opt_state or None, batch, cache or None) as ``meta``
    tensors, bf16 parameters as the reference's dry run takes them."""
    params = M.abstract_params(cfg, torch.bfloat16)
    batch = M.input_specs(cfg, shape)
    opt = abstract_opt_state(params, cfg.optimizer) if shape["kind"] == "train" else None
    cache = (M.abstract_cache(cfg, shape["global_batch"], shape["seq_len"])
             if shape["kind"] == "decode" else None)
    return params, opt, batch, cache


def count_step(cfg, shape):
    """The ``OpCounter`` of one step of ``cfg`` at ``shape`` on ``meta``."""
    params, opt, batch, cache = _abstract_inputs(cfg, shape)
    kind = shape["kind"]
    with OpCounter() as counter:
        if kind == "train":
            make_train_step(cfg, device="meta")(params, opt, batch)
        elif kind == "prefill":
            with torch.no_grad():
                M.prefill(cfg, params, batch)
        else:
            with torch.no_grad():
                M.decode_step(cfg, params, cache, batch["token"], shape["seq_len"] - 1)
    return counter


def _depth_knobs(cfg):
    """[(config field, repetitions of the deepest group it sets, a setter
    from repetitions to the field's value)] of the layer stacks that have
    more than two repetitions: the decoder's main group and the encoder."""
    knobs = []
    groups = M.layer_groups(cfg)
    period = len(cfg.block_pattern or ("attn",))
    rem = cfg.n_layers - groups[0][1] * period
    if groups[0][1] > 2:
        knobs.append(("n_layers", groups[0][1], lambda k: k * period + rem))
    if cfg.n_encoder_layers > 2:
        knobs.append(("n_encoder_layers", cfg.n_encoder_layers, lambda k: k))
    return knobs


def count_cell(cfg, shape) -> dict:
    """Global FLOPs and HBM bytes of one step. Each layer stack of n > 2
    repetitions is counted at 1 and 2 (the others at 1) and the count
    extrapolated: F(n) = F(1) + (n - 1) (F(2) - F(1)) for each stack, in
    exact integers."""
    knobs = _depth_knobs(cfg)
    if not knobs:
        st = count_step(cfg, shape).stats
        return {"flops": st.flops, "bytes": st.mem_bytes, "depth_extrapolated": False}
    base = dataclasses.replace(cfg, **{f: set_(1) for f, _, set_ in knobs})
    f1 = count_step(base, shape).stats
    flops, nbytes = f1.flops, f1.mem_bytes
    for field_, n, set_ in knobs:
        f2 = count_step(dataclasses.replace(base, **{field_: set_(2)}), shape).stats
        flops += (n - 1) * (f2.flops - f1.flops)
        nbytes += (n - 1) * (f2.mem_bytes - f1.mem_bytes)
    return {"flops": flops, "bytes": nbytes, "depth_extrapolated": True}


# ---------------------------------------------------------------------------
# The collective model
# ---------------------------------------------------------------------------


def collective_model(cfg, shape, mesh, params, pspecs):
    """Per-device collective traffic of one step on ``mesh``, modelled from
    the specs (not read from a compiled program) after the program that
    XLA's partitioner makes of the reference's step for host devices, which
    is what the reference's dry run records. n_d is the size of the data
    axes, n_m of 'model', B_d = B / n_d rows a device (B where the batch
    does not divide), L a leaf's bytes; each collective's traffic is its
    result's bytes times the reference analyzer's ring factor.

    Train and prefill, where ``act_spec`` splits the sequence over 'model'
    (sequence parallelism), so a device's activations outweigh a weight:

    * each weight leaf is gathered whole, over 'model' and then over the
      data axes, once for prefill and twice for train (forward, and the
      rematerialized backward); expert-stacked leaves keep their experts
      on 'model' and are gathered over the data axes only (L / n_m); the
      last position's row [B_d, D] of a prefill comes from the last
      'model' shard by a permute;
    * the embedding and the head (:func:`_table_terms`): the lookup gathers
      the table once, or, where the table's share outweighs the rows and
      tokens that the lookups would move (:func:`moves_lookups`: V past
      about B_d S at n_d = n_m), moves the lookups instead; train's
      gradient of the lookups is reduced whole, or moved as rows where
      V (n_m + 1) / n_m > 2 B_d S; train's head gathers its weight whole
      while V is at most the tokens of a loss chunk B c, and past that
      (or after a vision stub's prefix) splits the logits by the
      vocabulary; prefill's head gathers the weight's 'model' shard over
      the data axes (it reads the last position alone);
    * each attention layer of at most ``QCHUNK_THRESHOLD`` queries
      gathers its K and V [B_d, S, KV, dh] over 'model' (S the keys'
      length); train all-reduces dK and dV. A longer one runs query
      chunks against the keys' shards, and so does a shorter one whose K
      and V outweigh Q (2 KV > H, the same lengths): it gathers its
      queries Q [B_d, S, H, dh] over 'model' and all-reduces each chunk's
      partial output (Q's bytes in all) and its two float32 softmax
      statistics [B_d, H, S]; train gathers Q four times, all-reduces the
      outputs three times and the statistics five times (unchunked: Q five
      times, the statistics four, and an all-to-all of the float32 scores
      [B_d, H, S / n_m, S] over 'model'); where the chunks are fewer than
      the 'model' devices, each chunk's queries are split over
      n_m / chunks devices (:func:`_chunk_split_terms`);
    * each MoE layer gathers its tokens [B_d, S, D] over 'model' for the
      dispatch and all-reduces the top-k outputs [B_d, S k, D] over
      'model' for the combine; train gathers once more and all-reduces
      the dispatch's gradient [B_d, S, D]; the top-k gathers its float32
      router logits [B_d, S, E] over 'model' and the whole batch's
      [B, S, E] over the data axes, and its weights [B_d, S, k] over
      'model', a forward pass each;
    * train all-reduces each leaf's gradient over the data axes and over
      'model', whole (experts: L / n_m, over the data axes), as XLA emits
      it for host devices, a reduce-scatter being an all-reduce and a
      slice there;
    * each RWKV6 time-mix layer (keyed on its ``w_r``; K = H dh channels,
      T = ``rwkv_chunk``, n = S / T chunks, l the decay LoRA's rank, f32
      the float32 width of the tensors the reference casts for its chunk
      scan): the token shift's boundary row [B_d, D] from the previous
      'model' shard (a permute a forward pass; the backward's halo grows
      with 'model', n_m - 1 rows back and n_m - 2 forward); the chunk
      inputs r, k, v and w [B_d, S / n_m, K] f32
      moved from the sequence split to a split of the heads (all-to-alls,
      4 for prefill, 15 for train with their gradients); each chunk's
      output [B_d, T, K] f32 gathered over 'model' (n a forward pass);
      train gathers the mixed inputs of the weight gradients whole
      (three [B_d, S, D] and the LoRA's [B_d, S, l]) and all-reduces the
      inputs' gradients of the same shapes, and all-reduces u's gradient
      [K / n_m] f32 over the data axes once a chunk;
    * each Griffin recurrent block (keyed on its ``w_rec_in``, R channels):
      the conv's and the gates' inputs [B_d, S / n_m, R] moved from the
      sequence split to a split of the channels (two all-to-alls a pass,
      five in train), the recurrence's input [B_d, S, R] gathered over
      'model' for the gate products (a forward pass each, and the
      backward too where 1 < n_d < n_m); train gathers
      the block's input [B_d, S, D] and all-reduces the gradients of both
      (two of R channels, one of D);
    * the leaves whose input these gather whole (``GATHERED_INPUT``) reduce
      a 'model' shard's gradient over the data axes only; the RG-LRU gates
      are gathered over the data axes only (their 'model' shard), the
      chunk scan's and the recurrence's input projections once more in
      the backward.

    Decode, and any step whose sequence stays whole on 'model' (tensor
    parallelism):

    * each weight leaf that the data axes split is gathered over them
      (L / its 'model' shards), but not one that prefill ran (the encoder,
      the memory's K and V projections), and in decode not a dense one
      whose split dim is the product's output (``ROW_PARALLEL``, an
      untied embedding; an MoE architecture and RWKV6 gather those):
      there the whole batch's input rows [B, its contracted dims / their
      'model' shards] are gathered over the data axes and the output
      [B_d, D] goes back to the batch's split by an all-to-all, as the
      embedding's rows do once a step (not RWKV6's); decode's wk and wv,
      where the cache splits its KV heads over 'model' and their spec
      does not, only the shard of heads that the cache holds (L / n_m);
    * an all-reduce over 'model' of the block output [B_d, S, D] (S = 1
      for decode; the encoder's S / 4 for its own blocks) after each
      ``ROW_PARALLEL`` product whose contracted dim 'model' splits,
      twice in train; train all-reduces each gradient over the data axes;
    * each MoE layer whose experts 'model' splits all-reduces the top-k
      outputs [B_d, S k, D] over 'model'; decode moves the router onto
      'model' as it moves ``w_dec1`` and all-reduces the logits [B_d, E];
    * a tied embedding is gathered as the head's weight;
    * each RWKV6 layer gathers its ``w_o`` and channel mix's ``w_down``
      as it does its other leaves, moves ``w_dec1`` onto 'model' by a
      permute (L / n_m) where the data axes are no larger than 'model'
      and all-reduces the LoRA's partial sums [B_d, l], and gathers
      r, k, v and g [B_d, K] and the receptance [B_d, D] over 'model'
      (where K > D, the five mixed inputs [B_d, D], the new shift states
      and the head's input instead);
    * each Griffin recurrent block gathers its recurrence's input [B_d, R]
      over 'model' for the gates;
    * each attention layer whose cache the KV heads cannot split over
      'model' (split-KV) moves wk and wv onto 'model' by a permute where
      the data axes are no larger than 'model' (``_split_kv_terms``);
    * a batch that the data axes do not split (long_500k's one row) moves
      no weight: each product's output rows are all-reduced over the
      devices that split its contracted dims (``_replicated_terms``;
      experts contract their D, the down projection's output is gathered
      over the data axes twice, and the combine's [B, k, D] all-reduced
      over 'model'); split-KV attention moves its query, output and
      positions (:func:`_one_row_split_kv_terms`); RWKV6 permutes the
      token shift's new state [B, D / n_d] a layer and gathers all layers'
      over the data axes; a Griffin block permutes its recurrence's output
      [B, R / n_d].

    Not modelled: small reductions (the loss, norms of a few values); a
    sequence-split step's boundary rows but those of the RWKV6 steps and
    a vision stub's prefix; the bytes of a bf16 step, which XLA on the
    CPU moves as float32 (the model takes each tensor's width from the
    reference's casts); where 'model' outnumbers the data axes, the
    lookups' backward (taken as where the data axes outnumber 'model') and
    one-row decode; a vision stub's text rows past one loss chunk; cross
    attention with grouped queries whose chunks are fewer than the
    'model' devices; eight or more query chunks fewer than the 'model'
    devices (XLA then moves no scores). The tests hold the model against
    XLA's program of the reference's smoke steps, read by the reference's
    analyzer: ``test_collective_model_against_xla`` and
    ``test_torch_dryrun_recurrent.py`` on 2 x 2,
    ``test_torch_dryrun_mesh.py`` on 4 x 4 and 8 x 4 (the production
    meshes' n_d = n_m and n_d = 2 n_m) and 2 x 4,
    ``test_torch_dryrun_embed.py`` on both sides of each embedding and
    head boundary, one-row decode, and a ('data', 'model') = (2, 16) mesh
    (the production meshes' 'model'); ``tests/_xla_programs.py --table
    [--mesh]`` reads all ten archs.

    Returns (traffic bytes by kind, count by kind, {kind: {"count",
    "bytes"}} with each collective's result bytes, as the reference's
    ``parse_collectives`` records them)."""
    kind = shape["kind"]
    train = kind == "train"
    passes = 2 if train else 1
    dp = data_axes(mesh)
    n_d, n_m = _n_data(mesh), mesh.shape["model"]
    B = shape["global_batch"]
    B_d = B // n_d if B % n_d == 0 else B
    S = 1 if kind == "decode" else shape["seq_len"]
    S_enc = max(shape["seq_len"] // 4, 1)
    act = params["embed"].element_size()
    D = cfg.d_model
    aspec = SH.act_spec(cfg, mesh, S) if kind != "decode" else None
    seq_sharded = n_m > 1 and aspec is not None and "model" in aspec
    traffic, count, result = {}, {}, {}

    def add(k, n, res, group):
        if group < 2:
            return
        traffic[k] = traffic.get(k, 0.0) + n * _coll_traffic(k, res, group)
        count[k] = count.get(k, 0) + n
        ent = result.setdefault(k, {"count": 0, "bytes": 0})
        ent["count"] += n
        ent["bytes"] += int(n * res)

    shardings = dict(M.tree_leaves_with_path(SH.to_shardings(mesh, pspecs)))
    flat = dict(M.tree_leaves_with_path(params))
    # the RWKV6 layers (time-mix and channel-mix leaves share one) by key
    # prefix
    rwkv_layers = {k[: -len("w_r")] for k in flat if k.endswith("/w_r")}
    # decode moves a leaf that only the data axes split onto 'model' by a
    # permute where 'model' has as many devices (else it is gathered)
    resplit = 1 < n_d <= n_m
    # decode of a batch that the data axes do not split (long_500k's one
    # row): every device holds the whole batch
    replicated = kind == "decode" and n_d > 1 and B % n_d != 0
    if kind == "decode" and not replicated and not rwkv_layers:
        # the embedding's rows [B_d, D], split by D over the data axes,
        # moved to the batch's split (RWKV6's token shift gathers them)
        add("all-to-all", 1, B_d * D * act, n_d)
    if kind == "prefill" and seq_sharded:
        # the last position's row, from the last 'model' shard, for the
        # logits
        add("collective-permute", 1, B_d * D * act, n_m)
    for key, leaf in flat.items():
        path = key.split("/")
        name = path[-1]
        prefix = key[: -len(name)]
        rwkv = prefix in rwkv_layers
        # an attention layer decoding from a cache that its KV heads cannot
        # split over 'model', so split on its sequence (split-KV)
        split_kv = kind == "decode" and name in ("wk", "wv") and cfg.n_kv_heads % n_m != 0
        encoder = path[0] in ("enc_groups", "enc_final_norm")
        if kind == "decode" and (encoder or name in ("cwk", "cwv")):
            continue  # the encoder and the memory's K and V ran at prefill
        sh = shardings[key]
        L = leaf.numel() * leaf.element_size()
        stacked = path[0] in ("groups", "enc_groups")
        off = 1 if stacked else 0
        layers = leaf.shape[0] if stacked else 1
        expert = name in ("w_gate", "w_up", "w_down") and leaf.dim() - off == 3
        s_d, s_m = sh.shards_over(dp), sh.shards_over(("model",))
        contracted = ROW_PARALLEL.get(name, {}).get(leaf.dim() - off, ())
        if replicated:
            _replicated_terms(add, cfg, mesh, name, leaf, sh, off, contracted, layers, B, act,
                              expert)
            if split_kv and name == "wk":
                _one_row_split_kv_terms(add, flat[prefix + "wq"], leaf, layers, B, n_d, n_m, act)
                # the cache's int32 positions [n, T] from their split over
                # 'model' (T the cache's length, the window's if shorter)
                cap = shape["seq_len"] if cfg.attn_window is None else min(
                    shape["seq_len"], cfg.attn_window)
                add("all-gather", 1, layers * cap * 4, n_m)
            if name == "router" and "model" in shardings[prefix + "w_gate"].axes(off):
                add("all-reduce", layers, cfg.moe.top_k * B * D * act, n_m)
            if name == "w_r":
                # the token shift's new state [B, D], split over the data
                # axes, moved by a permute a layer, and all layers' [n, B, D]
                # gathered over them for the cache
                add("collective-permute", layers, B * D * act / n_d, n_m)
                add("all-gather", 1, layers * B * D * act, n_d)
            if name == "w_rec_in":
                # the recurrence's output [B, R] to the out projection's
                # split over the data axes, a permute of its shard
                add("collective-permute", layers, B * leaf.shape[-1] * act / n_d, n_m)
            continue
        if seq_sharded and name in ("embed", "lm_head"):
            _table_terms(add, cfg, kind, name, L, s_d, s_m, B, S, n_d, n_m, act)
            continue
        if seq_sharded and not expert:
            if name in GATHERED_INPUT_FWD:
                add("all-gather", passes, L / s_m, s_d)
            else:
                add("all-gather", passes, L / s_d, s_m)
                add("all-gather", passes, L, s_d)
            if train and name in GATHERED_INPUT:
                add("all-reduce", 1, L / s_m, n_d)
                if name in GATHERED_INPUT_BWD:
                    add("all-gather", 1, L / s_m, s_d)
            elif train:
                # (w_dec1's gradient goes over 'model' a data shard at a time)
                add("all-reduce", 1, L, n_d)
                add("all-reduce", 1, L / s_d if name == "w_dec1" else L, n_m)
        elif kind == "decode" and resplit and (name in ("w_dec1", "router") or split_kv):
            # re-split from the data axes onto the product's contracted dim
            # over 'model': one permute of a 'model' shard's bytes (the
            # router's partial logits [B_d, E] all-reduced over 'model')
            add("collective-permute", 1, L / n_m, s_d)
            if name == "router":
                add("all-reduce", layers, B_d * leaf.shape[-1] * act, n_m)
        else:
            # decode moves the rows of activations, not the weight, where the
            # data axes split a dense product's output (``ROW_PARALLEL``, an
            # untied embedding); an MoE architecture and RWKV6 gather it
            rows_move = (kind == "decode" and not expert and not rwkv
                         and ((contracted and cfg.moe is None)
                              or (name == "embed" and not cfg.tied_embeddings)))
            if (kind == "decode" and name in ("wk", "wv") and cfg.n_kv_heads % n_m == 0
                    and "model" not in sh.axes(off + 1)):
                # only the 'model' shard of heads that the cache holds there
                add("all-gather", passes, L / n_m, s_d)
            elif not rows_move:
                add("all-gather", passes, L / s_m, s_d)
            elif contracted:
                # the whole batch's input rows, their 'model' shard, gathered
                # over the data axes that split the product's output, and the
                # output [B_d, D] moved back to the batch's split
                rows = B * math.prod(leaf.shape[off + d] for d in contracted) / s_m
                add("all-gather", layers, rows * act, s_d)
                add("all-to-all", layers, B_d * D * act, s_d)
            if train:
                add("all-reduce", 1, L / s_m, n_d)
        if not seq_sharded and any("model" in sh.axes(off + d) for d in contracted):
            out = B_d * (S_enc if encoder else S) * D * act
            add("all-reduce", layers * passes, out, n_m)
        q_len = S_enc if encoder else S
        if seq_sharded and name in ("wk", "cwk"):
            wq = flat[prefix + name.replace("k", "q")]
            heads, kv_heads = wq.shape[-2], leaf.shape[-2]
            kv_len = S_enc if encoder or name == "cwk" else S
            q = B_d * q_len * math.prod(wq.shape[-2:]) * act
            kv = B_d * kv_len * math.prod(leaf.shape[-2:]) * act
            chunks = q_len > QCHUNK_THRESHOLD
            few_chunks = chunks and -(-q_len // QCHUNK) < n_m
            if few_chunks and (name == "wk" or kv_heads == heads):
                _chunk_split_terms(add, train, layers, B_d, q_len, kv_len, heads, kv_heads,
                                   leaf.shape[-1], n_m, act)
            elif (chunks and not few_chunks) or 2 * kv > q:
                # query chunks, or K and V outweighing Q: Q gathered, each
                # partial output and the two softmax statistics all-reduced;
                # unchunked, train's backward gathers Q once more, takes the
                # statistics from the forward and moves the float32 scores'
                # gradient [B_d, H, S / n_m, S] by an all-to-all over 'model'
                stats = B_d * heads * q_len * 4
                add("all-gather", layers * ((4 if chunks else 5) if train else 1), q, n_m)
                add("all-reduce", layers * (3 if train else 1), q, n_m)
                add("all-reduce", layers * ((5 if chunks else 4) if train else 2), stats, n_m)
                if train and not chunks:
                    add("all-to-all", layers, stats * q_len / n_m, n_m)
            else:
                add("all-gather", 2 * layers * passes, kv, n_m)
                if train:
                    add("all-reduce", 2 * layers, kv, n_m)
        if split_kv and name == "wk":
            _split_kv_terms(add, flat[prefix + "wq"], leaf, layers, B_d, n_m, act, resplit)
        if name == "w_r":
            _rwkv_terms(add, cfg, kind, seq_sharded, resplit, flat, prefix, layers, B_d, S, n_d,
                        n_m, act)
        if name == "w_rec_in":
            _rg_lru_terms(add, kind, seq_sharded, layers, B_d, S, D, leaf.shape[-1], n_d, n_m,
                          act)
        if name == "router" and "model" in shardings[prefix + "w_gate"].axes(off):
            tokens = B_d * S * D * act
            add("all-reduce", layers * passes, cfg.moe.top_k * tokens, n_m)
            if seq_sharded:
                add("all-gather", layers * (3 if train else 1), tokens, n_m)
                if train:
                    add("all-reduce", layers, tokens, n_m)
        if name == "router" and seq_sharded:
            # the top-k's float32 router logits [B_d, S, E] gathered over
            # 'model', the whole batch's [B, S, E] over the data axes, and
            # the top-k weights [B_d, S, k] over 'model', a forward pass each
            logits = S * leaf.shape[-1] * 4
            add("all-gather", layers * passes, B_d * logits, n_m)
            add("all-gather", layers * passes, B * logits, n_d)
            add("all-gather", layers * passes, B_d * S * cfg.moe.top_k * 4, n_m)
    return traffic, count, result


def moves_lookups(V, D, act, B, S, n_d, n_m) -> bool:
    """Whether XLA's partitioner moves the lookups of ``embed[tokens]``
    (B x S int32 tokens split over the data axes, a [V, D] table split
    (model, data) of ``act``-byte rows) rather than the table: where the
    table's share, V D act ((n_d - 1) / n_d + 1 / n_m) or, with the data
    axes ring-reduced, V D act (n_d - 1) / n_d, outweighs the rows
    [B_d, S, D] and tokens [B, S] that the lookups move instead,
    B_d S D act + 4 B S or B S D act (n_m - 1) / (n_m n_d) + 4 B S (N - 1) / N
    (N = n_d n_m): the smaller of the two boundaries, fitted to XLA's
    choice over n_d, n_m = 2..16, D = 32..1024, f32 and bf16 rows and
    2,048..131,072 tokens."""
    N, row, tokens = n_d * n_m, D * act, 4 * B * S
    bounds = [((B / n_d) * S * row + tokens) / (row * ((n_d - 1) / n_d + 1 / n_m))]
    if n_d > 1:
        bounds.append((B * S * row * (n_m - 1) / N + tokens * (N - 1) / N)
                      / (row * (n_d - 1) / n_d))
    return V > min(bounds)


def _table_terms(add, cfg, kind, name, L, s_d, s_m, B, S, n_d, n_m, act):
    """A sequence-split train or prefill step's traffic of the embedding
    [V, D] (split (model, data)) and the head (``lm_head`` [D, V] split
    (data, model), or the tied embedding's transpose), L bytes, whose
    choices XLA makes from the shapes:

    * the lookup gathers the table once (L / s_m over the data axes, then
      L over 'model') unless :func:`moves_lookups`; then it gathers the
      int32 tokens [B, S / n_m] over the data axes and [B, S] over 'model',
      all-reduces the rows it finds [B, S, D / n_d] over 'model', and moves
      a device's rows X = [B_d, S / n_m, D] to the activations' split: an
      all-to-all over the data axes, and a permute where n_d = n_m or an
      all-to-all over 'model' where n_d > n_m;
    * train reduces the lookup's gradient whole over both axes, unless the
      table's rows V (n_m + 1) / n_m outnumber twice a data shard's tokens
      2 B_d S: then the rows' gradient Y = [B_d, S, D] is gathered over
      'model' and moved by an all-to-all over the data axes (n_d = n_m: over
      the data axes, over 'model', and a permute), and the table's gradient
      [V, D / n_d] all-reduced over 'model' where V <= B S;
    * train's head gathers its weight whole in both passes and reduces its
      gradient over both axes while V <= B c, the tokens of a loss chunk
      (c = min(``LOSS_CHUNK``, S)); past that (or after a vision stub's
      prefix, whose text rows are out of step with the activations' split)
      it splits the logits by the vocabulary: the weight's 'model' shard
      gathered over the data axes in both passes, its gradient reduced
      over them, the softmax's max and sum [B_d, S] f32 all-reduced over
      'model'. Where it splits the logits or the loss runs in chunks
      (S > c) the final hidden states [B_d, S, D] are gathered over
      'model' in both passes and their gradient all-reduced, but where the
      k = S / c chunks are fewer than the 'model' devices: each chunk's
      states stay on its p = n_m / k devices, which gather the weight's
      p / n_m of the vocabulary (over 'model', then the data axes, in each
      pass) and reduce the chunk's gradients, of that share over both and
      of the states [B_d, c / p, D] over the p, and the softmax's max and
      the targets' logits [B_d, c / p] f32;
    * prefill's head reads the last position alone: the weight's 'model'
      shard is gathered over the data axes.

    A vision stub's text (S less its prefix) is what a train step looks up
    and scores."""
    train = kind == "train"
    prefix = cfg.n_prefix_embeds if train and cfg.frontend == "vision_stub" else 0
    S -= prefix
    D = cfg.d_model
    V = L // (D * act)
    B_d = B / n_d
    rows = B_d * S * D * act
    head = name == "lm_head" or cfg.tied_embeddings
    if head and not train:
        add("all-gather", 1, L / s_m, s_d)
    elif head:
        c = min(LOSS_CHUNK, S)
        k = S // c
        split_logits = V > B * c or prefix
        split_chunks = not split_logits and 1 < k < n_m and S % c == 0 and n_m % k == 0
        if split_logits:
            add("all-gather", 2, L / s_m, s_d)
            add("all-reduce", 1, L / s_m, n_d)
            add("all-reduce", 2, B_d * S * 4, n_m)
        elif split_chunks:
            p = n_m // k
            share = L * p / n_m
            add("all-gather", 2, share / s_d, p)
            add("all-gather", 2, share, s_d)
            add("all-reduce", k, share, p)
            add("all-reduce", k, share, n_d)
            add("all-reduce", k, B_d * (c // p) * D * act, p)
            add("all-reduce", 2 * k, B_d * (c // p) * 4, p)
        else:
            add("all-gather", 2, L / s_d, s_m)
            add("all-gather", 2, L, s_d)
            add("all-reduce", 1, L, n_d)
            add("all-reduce", 1, L, n_m)
        if split_logits or (S > c and not split_chunks):
            add("all-gather", 2, rows, n_m)
            add("all-reduce", 1, rows, n_m)
    if name == "embed":
        _lookup_terms(add, L, s_d, s_m, B, S, V, D, n_d, n_m, act, prefix, train)


def _lookup_terms(add, L, s_d, s_m, B, S, V, D, n_d, n_m, act, prefix, train):
    """The embedding lookup's part of :func:`_table_terms`; the text of a
    vision stub's one-chunk train step comes out split (None, model, data)
    and goes to the activations' split, and the prefix shifts it by
    P (n_m - 1) / n_m rows across the 'model' shards (a permute forward,
    two backward)."""
    B_d = B / n_d
    rows = B_d * S * D * act
    lookups = s_d > 1 and s_m > 1 and moves_lookups(V, D, act, B, S, n_d, n_m)
    shifted = prefix and S <= LOSS_CHUNK
    if lookups and not (shifted and n_d > n_m):
        add("all-gather", 1, 4 * B * S / n_m, n_d)
        add("all-gather", 1, 4 * B * S, n_m)
        add("all-reduce", 1, B * S * D * act / n_d, n_m)
    elif lookups:
        add("all-gather", 1, L / s_d, s_m)
        add("all-gather", 1, 4 * B * S / n_m, n_d)
    else:
        add("all-gather", 1, L / s_m, s_d)
        add("all-gather", 1, L, s_m)
    x = B_d * S / n_m * D * act
    if shifted:
        if not lookups:
            add("all-to-all", 1, x, n_d)
        add("all-gather", 1, rows, n_m)
        add("all-to-all", 1, rows, n_d)
        add("collective-permute", 3 if train else 1, B_d * prefix * (n_m - 1) / n_m * D * act,
            n_m)
    elif lookups:
        add("all-to-all", 1, x, n_d)
        if n_d == n_m:
            add("collective-permute", 1, x, n_m)
        elif n_d > n_m:
            add("all-to-all", 1, x, n_m)
    if not train:
        return
    if not (lookups and (shifted or V * (n_m + 1) / n_m > 2 * B_d * S)):
        add("all-reduce", 1, L, n_d)
        add("all-reduce", 1, L, n_m)
        return
    if n_d == n_m:
        add("all-gather", 1, rows, n_d)
        add("all-to-all", 1, rows, n_m)
        add("collective-permute", 1, rows, n_m)
    else:
        add("all-gather", 1, rows, n_m)
        add("all-to-all", 1, rows, n_d)
    if V <= B * S:
        add("all-reduce", 1, L / s_d, n_m)


def _chunk_split_terms(add, train, layers, B_d, S, S_kv, H, KV, dh, n_m, act):
    """Query-chunked attention of ``layers`` layers whose k = S / ``QCHUNK``
    chunks are fewer than the 'model' devices: each chunk's queries are
    split over p = n_m / k devices. With Q = [B_d, S, H, dh] (q bytes), KV
    = [B_d, S, KV, dh] (kv bytes) and the softmax statistics [B_d, H, S]
    f32 (st bytes), a layer moves, where a KV head serves at most k query
    heads (H <= k KV):

    * Q's p-th parts gathered over k devices (once in prefill, four times
      in train); each chunk's queries (q / k) gathered over its p devices
      (prefill once, train twice) and over a device list (train twice);
      each chunk's partial outputs (q / k) and their p-th parts all-reduced
      over device lists (prefill once each, train three times each), the
      statistics of each chunk over 'model' (prefill twice, train five
      times);
    * with fewer KV than query heads (grouped queries), train also gathers
      each chunk's statistics over its p devices and one chunk of K over a
      list; it moves the float32 scores of each chunk's queries against its
      share of the S_kv keys, [B_d, H, c / p, S_kv / k], by two all-to-alls
      over its p devices (so does cross attention, of S_kv memory keys).

    Where a KV head serves more (H > k KV), the chunk's K (kv / k) is gathered
    over lists (prefill twice, train five times) and once over its p
    devices in train, train's K and V gradients all-reduced over the p
    devices four times, and the partial outputs' p-th parts (q / (k p))
    and the statistics' (st / (k p)) are all-reduced over k devices (once
    and twice in prefill; twice and five times in train) and the outputs'
    once more over a list in train.

    The reference's analyzer reads a replica group written as a list of
    devices as a pair (``hlo_analysis._GROUPS``), so those collectives are
    counted over 2 here, as it records them."""
    k = -(-S // QCHUNK)
    p = n_m // k
    c = S // k
    q = B_d * S * H * dh * act
    kv = B_d * S_kv * KV * dh * act
    st = B_d * H * S * 4
    add("all-gather", layers * (4 if train else 1), q / p, k)
    if H > k * KV:
        add("all-gather", layers * (5 if train else 2), kv / k, 2)
        add("all-reduce", layers * k * (2 if train else 1), q / (k * p), k)
        add("all-reduce", layers * k * (5 if train else 2), st / (k * p), k)
        if train:
            add("all-gather", layers, kv / k, p)
            add("all-reduce", 4 * layers, 2 * kv / k, p)
            add("all-reduce", layers * k, q / (k * p), 2)
        return
    add("all-gather", layers * k * (2 if train else 1), q / k, p)
    add("all-reduce", layers * k * (3 if train else 1), q / k, 2)
    add("all-reduce", layers * k * (3 if train else 1), q / (k * p), 2)
    add("all-reduce", layers * k * (5 if train else 2), st / k, n_m)
    if train:
        add("all-gather", 2 * layers * k, q / k, 2)
        if KV < H:
            add("all-gather", layers * k, st / k, p)
            add("all-gather", layers, kv / k, 2)
        if KV < H or S_kv != S:
            add("all-to-all", 2 * layers * k, B_d * H * (c // p) * (S_kv // k) * 4, p)


def _split_kv_terms(add, wq, wk, layers, B_d, n_m, act, resplit):
    """Decode of ``layers`` attention layers whose cache the KV heads cannot
    split over 'model', so split on its sequence: each device attends over
    its share of the cached positions. The query [B_d, H, dh] is gathered
    from its heads' split and the float32 partial outputs of its shape
    all-reduced, each in two steps where g = gcd(KV, n_m) devices share a
    KV head's positions (over n_m / g, then over g); the two softmax
    statistics [B_d, H] are all-reduced over 'model', and the new token's
    K and V too where wk and wv re-split onto 'model'."""
    heads = wq.shape[-2]
    kv_heads, dh = wk.shape[-2:]
    g = math.gcd(kv_heads, n_m)
    q = B_d * heads * dh
    add("all-gather", layers, q * act / g, n_m // g)
    add("all-gather", layers, q * act, g)
    if resplit:
        add("all-reduce", layers, 2 * B_d * kv_heads * dh * act, n_m)
    add("all-reduce", layers, q * 4, n_m // g)
    add("all-reduce", layers, q * 4, g)
    add("all-reduce", 2 * layers, B_d * heads * 4, n_m)


def _one_row_split_kv_terms(add, wq, wk, layers, B, n_d, n_m, act):
    """Split-KV decode of a batch that every device holds whole: the query
    [B, H, dh] gathered from its heads' split (in two steps where
    g = gcd(KV, n_m) > 1, as :func:`_split_kv_terms`; else from a device
    list that the reference's analyzer reads as a pair), a shard of it (its
    'model' shard, or its data shard where g = 1) and a 'model' shard of the
    float32 output permuted, the output's shard
    all-reduced over 'model', and the two softmax statistics [B, H] f32."""
    heads = wq.shape[-2]
    kv_heads, dh = wk.shape[-2:]
    g = math.gcd(kv_heads, n_m)
    q = B * heads * dh
    if g > 1:
        add("all-gather", layers, q * act / g, n_m // g)
        add("all-gather", layers, q * act, g)
    else:
        add("all-gather", layers, q * act, 2)
    add("collective-permute", layers, q * act / (n_m if g > 1 else n_d), n_m)
    add("collective-permute", layers, q * 4 / n_m, n_m)
    add("all-reduce", layers, q * 4 / n_m, n_m)
    add("all-reduce", 2 * layers, B * heads * 4, n_m)


def _replicated_terms(add, cfg, mesh, name, leaf, sh, off, contracted, layers, B, act, expert):
    """Decode of a batch that every device holds whole: no weight moves;
    each product's output rows [B, its output dims / their shards] are
    all-reduced over the devices that split its contracted dims (the
    input's, or ``ROW_PARALLEL``'s), and a tied embedding's once more as
    the head. Experts [E, D, F] split over 'model' contract their D; the
    down projection's [B, E / n_m, D] output, split over the data axes,
    is gathered over them, and once more for the weighted combine."""
    if leaf.dim() - off < 2 or name in ("ln_w", "ln_b"):
        return  # norms, biases, mixes and decays act elementwise

    def shards(d):
        return math.prod(mesh.shape[a] for a in sh.axes(off + d))

    def out_rows(dims):
        return B * math.prod(leaf.shape[off + d] / shards(d) for d in range(leaf.dim() - off)
                             if d not in dims) * act

    if expert and name == "w_down":
        add("all-gather", 2 * layers, out_rows((1,)) * shards(2), shards(2))
        return
    dims = (1,) if expert else contracted or (0,)
    n_m = mesh.shape["model"]
    if name in ("wk", "wv") and cfg.n_kv_heads % n_m == 0 and not sh.axes(off + 1):
        # the new K and V split over 'model' by heads, as the cache is
        act = act / n_m
    add("all-reduce", layers, out_rows(dims), math.prod(shards(d) for d in dims))
    if name == "embed" and cfg.tied_embeddings:
        add("all-reduce", 1, out_rows((1,)), shards(1))


def _rwkv_terms(add, cfg, kind, seq_sharded, resplit, flat, prefix, layers, B_d, S, n_d, n_m,
                act):
    """The activation traffic of ``layers`` RWKV6 layers: the time mix (the
    reference's ``rwkv_time_mix``, ``..._decode`` for decode) of K = H dh
    channels in chunks of T = ``rwkv_chunk`` (n = ceil(S / T) of them), with
    its decay LoRA of rank ``lora``, and in decode the channel mix's
    receptance."""
    K = flat[prefix + "w_r"].shape[-1]
    lora = flat[prefix + "w_dec1"].shape[-1]
    D = cfg.d_model
    if kind == "decode":
        # the dd partial sums of a re-split w_dec1; r, k, v and g, and the
        # channel mix's receptance, gathered over 'model'; where K > D, the
        # mixed inputs [B_d, D] of the four and of the decay LoRA instead,
        # the new shift states [n, B_d, D] and the head's input [B_d, D]
        if resplit:
            add("all-reduce", layers, B_d * lora * act, n_m)
        if K > D:
            add("all-gather", 5 * layers, B_d * D * act, n_m)
            add("all-gather", 1, layers * B_d * D * act, n_m)
            add("all-gather", 1, B_d * D * act, n_m)
            return
        add("all-gather", 4 * layers, B_d * K * act, n_m)
        add("all-gather", layers, B_d * D * act, n_m)
        return
    if not seq_sharded:
        return
    train = kind == "train"
    T = cfg.rwkv_chunk
    n = -(-S // T)
    # the token shift's boundary row from the previous 'model' shard, a
    # forward pass each; the backward's halo grows with 'model': n_m - 1
    # rows of the shift's gradient back, n_m - 2 rows forward
    row = B_d * D * act
    add("collective-permute", (2 if train else 1) * layers, row, n_m)
    if train:
        add("collective-permute", layers, (n_m - 1) * row, n_m)
        if n_m > 2:
            add("collective-permute", layers, (n_m - 2) * row, n_m)
    # the float32 chunk inputs r, k, v and w moved from the sequence split
    # to a split of the heads for the scan over chunks: four a pass (train:
    # forward, rematerialized forward, backward), train three more for the
    # gradients of the decay and the mixes
    add("all-to-all", (15 if train else 4) * layers, B_d * (n * T // n_m) * K * 4, n_m)
    # each chunk's float32 output gathered over 'model', a forward pass each
    add("all-gather", (2 if train else 1) * n * layers, B_d * T * K * 4, n_m)
    if train:
        # the mixed inputs of the weight gradients gathered whole, and the
        # inputs' gradients all-reduced: three of D channels and the LoRA's
        for k in ("all-gather", "all-reduce"):
            add(k, 3 * layers, B_d * S * D * act, n_m)
            add(k, layers, B_d * S * lora * act, n_m)
        # the bonus u's gradient, a chunk at a time, over the data axes
        add("all-reduce", n * layers, K // n_m * 4, n_d)


def _rg_lru_terms(add, kind, seq_sharded, layers, B_d, S, D, R, n_d, n_m, act):
    """The activation traffic of ``layers`` Griffin recurrent blocks (the
    reference's ``recurrent_block``; ``..._decode`` for decode) of R
    recurrence channels."""
    if kind == "decode":
        # the recurrence's input gathered over 'model' for its gates
        add("all-gather", layers, B_d * R * act, n_m)
        return
    if not seq_sharded:
        return
    train = kind == "train"
    # the conv's input and the gated input moved from the sequence split to
    # a split of the channels for the scan: two a pass, train one more
    add("all-to-all", (5 if train else 2) * layers, B_d * (S // n_m) * R * act, n_m)
    # the recurrence's input gathered whole for the gate products, a
    # forward pass each, and in the backward too where 'model' outnumbers
    # the data axes (XLA's choice: seen on 2 x 4 and 2 x 8, not on 2 x 2,
    # 4 x 4, 4 x 2 or 1 x 8)
    gathers = (3 if 1 < n_d < n_m else 2) if train else 1
    add("all-gather", gathers * layers, B_d * S * R * act, n_m)
    if train:
        # the gates' and the input projections' inputs and gradients
        add("all-gather", layers, B_d * S * D * act, n_m)
        add("all-reduce", 2 * layers, B_d * S * R * act, n_m)
        add("all-reduce", layers, B_d * S * D * act, n_m)


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, multi_pod: bool, counts: dict = None) -> dict:
    """One cell's record. ``counts`` maps (arch, shape) to
    :func:`count_cell`'s result, which does not depend on the mesh: a cell
    found there is not counted again, and one counted here is added."""
    counts = {} if counts is None else counts
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod), "status": "ok"}
    try:
        cfg = get_config(arch)
        shape = SHAPES[shape_name]
        mesh = make_production_mesh(multi_pod=multi_pod)
        params, opt, batch, cache = _abstract_inputs(cfg, shape)
        pspecs = SH.param_specs(cfg, mesh, params)
        args_bytes = tree_bytes_per_device(params, pspecs, mesh)
        if opt is not None:
            args_bytes += tree_bytes_per_device(opt, SH.opt_specs(cfg, mesh, opt, pspecs), mesh)
        if shape["kind"] == "decode":
            args_bytes += tree_bytes_per_device(cache, SH.cache_specs(cfg, mesh, cache), mesh)
        else:
            args_bytes += tree_bytes_per_device(batch, SH.batch_specs(mesh, batch), mesh)
        traffic, ccount, collectives = collective_model(cfg, shape, mesh, params, pspecs)
        t1 = time.time()
        if (arch, shape_name) not in counts:
            counts[arch, shape_name] = count_cell(cfg, shape)
        counted = counts[arch, shape_name]
        t2 = time.time()
        rec["lower_s"] = round(t1 - t0, 1)
        rec["compile_s"] = round(t2 - t1, 1)
        rec["memory_analysis"] = "unavailable: the port has no compiler; see analytic_bytes_per_device"
        rec["analytic_bytes_per_device"] = int(args_bytes)
        rec["cost_analysis"] = {"flops": float(counted["flops"]),
                                "bytes accessed": float(counted["bytes"])}
        rec["collectives"] = collectives
        rec["hlo_bytes"] = None
        rec["depth_extrapolated"] = counted["depth_extrapolated"]
        n_chips = mesh.size
        rec["hlo_stats"] = {
            "flops_per_device": counted["flops"] / n_chips,
            "mem_bytes_per_device": counted["bytes"] / n_chips,
            "coll_bytes_per_device": traffic,
            "coll_count": ccount,
        }
    except Exception as e:  # recorded, not swallowed: the record says fail
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def load_results() -> list:
    if RESULTS.exists():
        return json.loads(RESULTS.read_text())
    return []


def save_results(res: list) -> None:
    RESULTS.parent.mkdir(parents=True, exist_ok=True)
    RESULTS.write_text(json.dumps(res, indent=1))


def run_db_plane(multi_pod: bool, device: str = "cuda", rows: int = 1 << 26) -> dict:
    """The distributed GraftDB data plane (the bucketed-exchange hash
    join, the summed aggregate and the shard-local fused chain) on a
    ``DataMesh`` of the production mesh's data-axis size (16, or 32 over
    two pods) on ``device``, at the reference's 64 M rows. Delegates to
    ``launch.db_plane``."""
    from .db_plane import db_plane_record

    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = db_plane_record(DataMesh(_n_data(mesh), device), rows=rows)
    rec["mesh"] = mesh_name(multi_pod)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", choices=["on", "off", "both"], default="off")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--redo", action="store_true")
    ap.add_argument("--db-plane", action="store_true")
    args = ap.parse_args(argv)
    pods = {"on": [True], "off": [False], "both": [False, True]}[args.multi_pod]

    if args.db_plane:
        from .db_plane import validate_db_plane_record

        results = load_results()
        for mp in pods:
            rec = run_db_plane(mp)
            key = (rec["arch"], rec["shape"], rec["mesh"])
            results = [r for r in results if (r["arch"], r["shape"], r["mesh"]) != key]
            results.append(rec)
            save_results(results)
            try:
                validate_db_plane_record(rec)
                valid = "valid"
            except ValueError as e:
                valid = f"INVALID ({e})"
            print(f"db-plane {rec['mesh']}: {rec['status']} ({valid}) "
                  f"coll={rec.get('hlo_stats', {}).get('coll_count')} "
                  f"chain={rec.get('chain')}", flush=True)
        return

    todo = []
    for a, s in cells():
        if args.arch and a != args.arch:
            continue
        if args.shape and s != args.shape:
            continue
        for mp in pods:
            todo.append((a, s, mp))

    results = load_results()
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results if r["status"] == "ok"}
    counts = {}  # (arch, shape) -> count_cell's result, for both meshes
    for a, s, mp in todo:
        key = (a, s, mesh_name(mp))
        if key in done and not args.redo:
            print(f"skip {key} (cached)")
            continue
        print(f"=== dry-run {key} ===", flush=True)
        rec = run_cell(a, s, mp, counts)
        results = [r for r in results if (r["arch"], r["shape"], r["mesh"]) != key]
        results.append(rec)
        save_results(results)
        print(
            f"--> {rec['status']} lower={rec.get('lower_s')}s count={rec.get('compile_s')}s"
            + (f" err={rec.get('error')}" if rec["status"] != "ok" else ""),
            flush=True,
        )


if __name__ == "__main__":
    main()
