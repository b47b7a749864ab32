"""The production-mesh dry run: one rank's step of every (arch x shape x
mesh) cell, on meta tensors under torch's fake process group.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell's step (``train_step`` for ``train_4k``, ``prefill`` for
``prefill_32k``, ``decode_step`` for ``decode_32k`` and ``long_500k``)
against abstract parameters on 512 host devices and reads the compiled
program's memory, cost and collectives.  The port has no partitioner to
ask: its partitioned program (``distributed/partition.py``) is what each
rank runs.  So rank 0 of the production mesh (16 x 16 "single", 256 ranks;
2 x 16 x 16 "multi", 512) runs that program once, on ``device="meta"``
tensors of its exact local shapes and dtypes (``partition.build_params``
draws nothing on meta), in one process under torch's fake process group,
whose exchanges move nothing.  Values are meaningless there; shapes,
products and exchanges are the rank's own.

Each record keeps the reference's keys:

- ``memory``: ``argument_size_in_bytes`` (rank 0's params, optimizer
  moments, batch and cache, exact; the port's steps take the global batch
  on every rank), ``output_size_in_bytes`` (what the step returns),
  ``alias_size_in_bytes`` (what it writes in place: the ring cache of a
  decode step, the params and moments of a train step: the reference's
  ``donate_argnums``), ``temp_size_in_bytes`` (the most bytes the step
  allocates beside its arguments and holds at once, its new outputs
  included, tracked op by op (:class:`StepCounts`)) for a train cell,
  whose fake-quantized step runs the same PyTorch ops on the card; None
  for a serving cell, with ``temp_not_measured`` saying why: on meta its
  integer products take the plain route, whose float64 products the
  CUDA kernels that serve it on the card never make;
- ``cost``: rank 0's FLOPs.  ``torch.utils.flop_counter``'s formulas count
  the aten matrix products (``flops_counted``, :class:`StepCounts`); the
  one product the port writes as multiply-and-sum, the SSD decode step's
  readout (``layers/ssd.py::ssd_step``), is added from the config
  (``flops_added``); elementwise work is counted nowhere (XLA's cost
  analysis counts it);
- ``cost_unrolled``: the same step on one rank, unpartitioned: the whole
  program's FLOPs (one query chunk where attention has no window, as the
  reference's cost pass: the plain path scores whole key rows per chunk,
  so chunking moves no FLOP);
- ``collectives``: the bytes of every exchange's result by kind
  (``collectives.RESULT``, the reference's ``collective_bytes``);
  ``collectives_scaled`` equals it, since the port runs every layer and
  no loop body is counted once;
- ``wire``: the bytes rank 0 sends by kind (``collectives.WIRE``);
- ``launches``: the dispatch counts of the step (``dispatch.STATS``; the
  plain ``*_torch`` calls here, whose ``*_cuda`` counterparts launch the
  kernels on the card); ``kernel_launches``: the kernels' own counts;
- ``status`` ("ok", "skipped" with ``reason``, "error" with ``error``) and
  ``seconds``.

Variants (the reference's ``--variant``): ``packed`` (nibble-packed int4
weights), ``kv4`` (packed weights and a 4-bit ring), ``nofsdp`` (experts
not split over "data" in training), ``bf16red`` and ``a2a`` (the
row-parallel bf16 reduce and the all-to-all expert dispatch,
``Rules(int_bf16_reduce=..., moe_a2a=...)``), ``opt`` (packed, both),
``sp`` (the reference's Megatron-SP residual, ``Rules(seq_tp=
("model",))``: the residual's sequence split over "model" between the
blocks, ``distributed/partition.py::seq_split``; a decode step and
Whisper's stacks keep it whole, so their records equal the baseline's).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both

It runs on the CPU and needs no card; more than one cell runs in a
process each, as many at once as the process may use cores.  Results go
to an incremental JSON (``--out``, default
``results/dryrun_torch.local.json``, which git ignores), resumed unless
``--force``.  The records the repo keeps are ``results/dryrun_torch.json``:
refresh a variant's there with ``--out results/dryrun_torch.json
--force``, which reruns those cells and keeps the other records.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import time
import traceback
import weakref
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import _pytree as pytree
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.registry import (ARCHS, SHAPES, cell_supported,
                                          get_config, input_specs, is_encdec)
from repro_torch.core.api import QuantConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed import partition
from repro_torch.distributed.sharding import Rules, axis_sizes, use_rules
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.train import make_train_step
from repro_torch.models import encdec, lm
from repro_torch.optim import OptConfig, init_opt_state

TRAIN_QUANT = QuantConfig(w_bits=4, a_bits=8, attn_bits=7, mode="fake")
SERVE_QUANT = QuantConfig(w_bits=4, a_bits=8, attn_bits=7, kv_bits=8,
                          mode="int")
MESHES = {"single": 16 * 16, "multi": 2 * 16 * 16}
VARIANTS = ("packed", "kv4", "nofsdp", "bf16red", "a2a", "opt", "sp")
TEMP_INT = ("int mode: the plain route's float64 products on meta, which "
            "the CUDA kernels serving the step on the card never make")


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """torch's fake process group of ``world`` ranks as the default group
    (this process is ``rank``) for the block, destroyed after it.  Refuses
    to replace a default group that exists."""
    if dist.is_initialized():
        raise RuntimeError("a default process group exists; the dry run "
                           "makes its own fake one")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _batch_axes(mesh, global_batch):
    sizes = axis_sizes(mesh)
    axes = [a for a in ("pod", "data") if a in sizes]
    n = math.prod(sizes[a] for a in axes)
    return tuple(axes) if (global_batch % n == 0 and global_batch >= n) \
        else ()


def nbytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (dicts, lists and tuples)."""
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class Cell:
    """One cell's step and its arguments, ready to run once."""
    kind: str                     # "train" | "prefill" | "decode"
    cfg: object
    rules: Optional[Rules]        # None: one rank, unpartitioned
    step: object                  # step(**args)
    args: dict
    donate: tuple                 # names of the args written in place
    rows: int                     # the batch rows this rank runs

    def run(self):
        return self.step(**self.args)


def _serve_quant(variant):
    if variant in ("packed", "opt"):
        return SERVE_QUANT.replace(pack_weights=True)
    if variant == "kv4":
        return SERVE_QUANT.replace(pack_weights=True, kv_bits=4)
    return SERVE_QUANT


def _materialize(specs: dict, cfg, device) -> dict:
    """Inputs of ``specs``' shapes on ``device`` (meta: the specs): token
    ids below the vocabulary, normal floats (frames, patches), seeded."""
    if torch.device(device).type == "meta":
        return specs
    gen = torch.Generator(device=device).manual_seed(1)
    return {k: (torch.randint(0, cfg.vocab, s.shape, generator=gen,
                              device=device, dtype=s.dtype)
                if not s.dtype.is_floating_point else
                torch.randn(s.shape, generator=gen, device=device,
                            dtype=s.dtype))
            for k, s in specs.items()}


def _make_cell(arch, shape, mesh, *, remat=True, expert_fsdp=None,
               variant=None, cfg=None, seq=None, batch=None, device="meta",
               for_cost=False) -> Cell:
    """Rank ``mesh``'s step of one cell (``mesh`` None: one rank,
    unpartitioned).  ``cfg``, ``seq`` and ``batch`` cut the cell to size
    (default: the registry's config and the shape's own); ``device`` "meta"
    gives shapes only, another device real tensors (weights from seed 0,
    the ring's positions as after ``seq - 1`` tokens, so a decode step
    reads the whole ring).  ``for_cost``: one query chunk where attention
    has no window (the reference's flop-accounting cell)."""
    cfg0 = cfg or get_config(arch)
    seq0, gb0, kind = SHAPES[shape]
    seq, gb = seq or seq0, batch or gb0
    encdec_arch = is_encdec(cfg0)
    if for_cost and (encdec_arch or cfg0.attn_window is None):
        cfg0 = cfg0.replace(q_chunk=max(seq, cfg0.q_chunk))
    if variant == "nofsdp":
        expert_fsdp = False
    if expert_fsdp is None:
        expert_fsdp = kind == "train"
    if kind == "train":
        cfg = cfg0.replace(quant=TRAIN_QUANT)
        if not encdec_arch:
            cfg = cfg.replace(remat=remat)
    else:
        cfg = cfg0.replace(quant=_serve_quant(variant))
    layout, rules, bax = None, None, ()
    if mesh is not None:
        bax = _batch_axes(mesh, gb)
        layout = partition.Layout.of(mesh, bax, fsdp=expert_fsdp)
        rules = Rules(batch=bax, mesh=mesh, partitioned=True,
                      seq_tp=("model",) if variant == "sp" else (),
                      int_bf16_reduce=variant in ("bf16red", "opt"),
                      moe_a2a=variant in ("a2a", "opt"),
                      expert_fsdp=expert_fsdp)
    rows = gb // (layout.size(bax) if layout is not None else 1)
    params = partition.build_params(cfg, seed=0, layout=layout,
                                    device=device)
    _, specs = input_specs(arch, shape, cfg, seq=seq, batch=gb)
    inputs = _materialize(specs, cfg, device)
    model = encdec if encdec_arch else lm

    if kind == "train":
        with use_rules(rules):
            shards = partition.opt_shards(params, cfg)
        opt_state = init_opt_state(params, shards)
        return Cell(kind, cfg, rules,
                    make_train_step(cfg, OptConfig(total_steps=10000)),
                    {"params": params, "opt_state": opt_state,
                     "batch": inputs}, ("params", "opt_state"), rows)
    if kind == "prefill":
        return Cell(kind, cfg, rules,
                    lambda params, batch: model.prefill(params, batch, cfg),
                    {"params": params, "batch": inputs}, (), rows)
    if layout is not None:
        cache = partition.init_cache(cfg, gb, seq, layout, device=device)
    else:
        cache = model.init_cache(cfg, gb, seq, device=device)
    for pos in (cache["pos"], cache.get("layers", {}).get("pos")):
        if pos is not None:
            pos.fill_(seq - 1)
    return Cell(kind, cfg, rules,
                lambda params, token, cache: model.decode_step(
                    params, token, cache, cfg),
                {"params": params, "token": inputs["token"], "cache": cache},
                ("cache",), rows)


# ---------------------------------------------------------------------------
# Counting one run of a cell
# ---------------------------------------------------------------------------

def _cacheable(func) -> bool:
    """``func`` returns one new tensor and writes none of its inputs: its
    result's shape, strides and dtype follow from its arguments'."""
    schema = func._schema
    ret = schema.returns
    return not schema.is_mutable and len(ret) == 1 and \
        ret[0].alias_info is None and str(ret[0].type) == "Tensor"


def _meta_key(a):
    """A hashable key of an argument's shape-level content: a meta
    tensor's shape, strides and dtype, a number's type and value; None
    where the argument holds anything else (a tensor off meta)."""
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), a.stride(), a.dtype) if a.is_meta else None
    if isinstance(a, (list, tuple)):
        keys = tuple(_meta_key(x) for x in a)
        return None if None in keys else (type(a), keys)
    if a is None or isinstance(a, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.layout,
                                   torch.memory_format)):
        return (type(a), a)
    return None


class MetaResults:
    """Each new result an op makes on meta tensors, by the op and its
    arguments' shapes, strides, dtypes and numbers: the first call runs the
    op's meta function (most of torch's are Python references, which take
    most of a meta step's time), every later one with the same
    key gets a new tensor of the same shape, strides and dtype.  Ops that
    write their inputs or return views of them (``_unsafe_view``'s schema
    does not say so: its first view tells) always run."""

    def __init__(self):
        self.results, self.ok = {}, {}

    def __call__(self, func, args, kwargs):
        ok = self.ok.get(func)
        if ok is None:
            ok = self.ok[func] = _cacheable(func)
        if not ok or not any(isinstance(a, torch.Tensor) for a in args):
            return func(*args, **kwargs)
        key = (func, _meta_key(args), _meta_key(tuple(kwargs.items())))
        if None in key[1:]:
            return func(*args, **kwargs)
        got = self.results.get(key)
        if got is None:
            out = func(*args, **kwargs)
            st = out.untyped_storage()._cdata
            if any(isinstance(a, torch.Tensor) and
                   a.untyped_storage()._cdata == st
                   for a in pytree.tree_leaves(args)):
                self.ok[func] = False     # a view its schema does not say
                return out
            self.results[key] = (out.shape, out.stride(), out.dtype,
                                 out.device)
            return out
        shape, stride, dtype, device = got
        return torch.empty_strided(shape, stride, dtype=dtype, device=device)


class StepCounts(TorchDispatchMode):
    """What the ops under the mode do, one op at a time:

    - ``flops``: each op's FLOPs by ``torch.utils.flop_counter``'s formulas
      (``flop_registry``, the matrix products), as ``FlopCounterMode``
      counts them, without its attempt to decompose every other op (a
      second dispatch an op; the products reach the mode decomposed
      already: ``tests/test_torch_dryrun.py`` holds the two equal);
    - ``peak`` (with ``memory``): the most bytes of storage the ops create
      and hold at once, each new storage counted from the op that makes it
      until it is freed; the storages of ``external`` (the step's
      arguments, which views and in-place writes return) never count.
      What ``torch.distributed._tools.mem_tracker.MemTracker`` tracks as
      its peak beside the tensors given to its ``track_external``.

    Ops on meta tensors take their results from :class:`MetaResults`."""

    def __init__(self, external=(), memory: bool = True):
        super().__init__()
        self.flops, self.memory = 0, memory
        self.meta = MetaResults()
        self.live, self.cur, self.peak = {}, 0, 0
        self.external = {t.untyped_storage()._cdata
                         for t in pytree.tree_leaves(external)
                         if isinstance(t, torch.Tensor)}

    def _free(self, key):
        self.cur -= self.live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self.meta(func, args, kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if self.memory:
            for t in pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._track(t.untyped_storage())
        return out

    def _track(self, st):
        key = st._cdata
        if key in self.live or key in self.external:
            return
        self.live[key] = st.nbytes()
        self.cur += self.live[key]
        self.peak = max(self.peak, self.cur)
        weakref.finalize(st, self._free, key)


def uncounted_flops(cell: Cell) -> int:
    """FLOPs of the products the port writes as multiply-and-sum, which
    ``FlopCounterMode`` does not see: a decode step's SSD readout
    ``(C * h).sum(-1)`` (``layers/ssd.py::ssd_step``), 2·B·H·P·N a layer
    on the rank's rows (the SSD mixer is whole on every model rank)."""
    cfg = cell.cfg
    if cell.kind != "decode" or is_encdec(cfg) or cfg.ssd is None:
        return 0
    s = cfg.ssd
    d_inner = s.expand * cfg.d_model
    n_ssd = lm.block_kinds(cfg).count("ssd")
    return n_ssd * 2 * cell.rows * (d_inner // s.head_dim) * s.head_dim * \
        s.d_state


def measure(cell: Cell, *, backend: str = "torch", memory: bool = True):
    """Run ``cell`` once on ``backend`` and count it: ``(record, outputs)``
    with the record's ``memory`` (``temp_size_in_bytes`` None unless
    ``memory`` and the cell runs outside int mode), ``cost``,
    ``collectives``, ``collectives_scaled``, ``wire``, ``launches`` and
    ``kernel_launches``."""
    col.reset_wire()
    dispatch.reset_stats()
    dispatch.reset_launches()
    int_mode = cell.cfg.quant.mode == "int"
    memory = memory and not int_mode
    counts = StepCounts(cell.args, memory=memory)
    grad = contextlib.nullcontext() if cell.kind == "train" \
        else torch.no_grad()
    with use_rules(cell.rules), dispatch.use_backend(backend), grad, counts:
        out = cell.run()
    counted = counts.flops
    added = uncounted_flops(cell)
    coll = {k: v for k, v in col.RESULT.items() if v}
    rec = {"memory": {
        "argument_size_in_bytes": nbytes(cell.args),
        "output_size_in_bytes": nbytes(out),
        "alias_size_in_bytes": nbytes([cell.args[k] for k in cell.donate]),
        "temp_size_in_bytes": counts.peak if memory else None,
        **({"temp_not_measured": TEMP_INT} if int_mode else {})},
        "cost": {"flops": counted + added, "flops_counted": counted,
                 "flops_added": added},
        "collectives": coll, "collectives_scaled": dict(coll),
        "wire": {k: v for k, v in col.WIRE.items() if v},
        "launches": {k: v for k, v in dispatch.snapshot().items()
                     if k != "blocks" and v},
        "kernel_launches": {k: v for k, v in
                            dispatch.launch_counts().items() if v}}
    return rec, out


def run_cell(arch, shape, mesh_kind, *, verbose=True, remat=True,
             expert_fsdp=None, variant=None):
    """One cell's record (:func:`measure` of rank 0 on the production
    mesh, and ``cost_unrolled`` of the unpartitioned step), its failure
    recorded as ``status: "error"``."""
    t0 = time.time()
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "variant": variant or "baseline"}
    ok, why = cell_supported(arch, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        with fake_group(MESHES[mesh_kind]):
            mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                        device_type="cpu")
            cell = _make_cell(arch, shape, mesh, remat=remat,
                              expert_fsdp=expert_fsdp, variant=variant)
            got, _ = measure(cell)
            del cell
            rec.update(got)
            cost = _make_cell(arch, shape, None, remat=remat,
                              expert_fsdp=expert_fsdp, variant=variant,
                              for_cost=True)
            rec["cost_unrolled"] = measure(cost, memory=False)[0]["cost"]
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record and continue
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["trace"] = traceback.format_exc()[-2000:]
    rec["seconds"] = round(time.time() - t0, 1)
    if verbose:
        flops = rec.get("cost", {}).get("flops", 0)
        gb = rec.get("memory", {}).get("argument_size_in_bytes", 0) / 1e9
        print(f"[dryrun] {arch} x {shape} x {mesh_kind} x {rec['variant']}: "
              f"{rec['status']} ({rec['seconds']}s, args {gb:.2f} GB, "
              f"flops={flops:.3g})", flush=True)
        if rec["status"] == "error":
            print(rec["error"], flush=True)
    return rec


def cell_key(arch, shape, mesh_kind, variant=None) -> str:
    return f"{arch}|{shape}|{mesh_kind}" + (f"|{variant}" if variant else "")


def _run_one(job):
    torch.set_num_threads(1)
    arch, shape, mesh_kind, kw = job
    return cell_key(arch, shape, mesh_kind, kw.get("variant")), \
        run_cell(arch, shape, mesh_kind, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.local.json")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default=None, choices=VARIANTS,
                    help="perf variant: " + "|".join(VARIANTS))
    args = ap.parse_args(argv)

    archs = [a for a in ARCHS if a != "deit-s"] if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    kw = {"remat": not args.no_remat, "variant": args.variant}
    todo = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                prev = results.get(cell_key(arch, shape, mesh_kind,
                                            args.variant))
                if prev and prev.get("status") in ("ok", "skipped") \
                        and not args.force:
                    continue
                todo.append((arch, shape, mesh_kind, kw))

    def keep(key, rec):
        results[key] = rec
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    t0 = time.time()
    jobs = min(len(os.sched_getaffinity(0)), len(todo))
    if jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(jobs, maxtasksperchild=1) as pool:
            for key, rec in pool.imap_unordered(_run_one, todo):
                keep(key, rec)
    else:
        for job in todo:
            keep(*_run_one(job))
    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_skip = sum(1 for r in results.values() if r["status"] == "skipped")
    n_err = sum(1 for r in results.values() if r["status"] == "error")
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"({time.time() - t0:.1f} s)")
    return n_err


if __name__ == "__main__":
    raise SystemExit(1 if main() else 0)
