"""Multi-pod dry-run: one device's share of a step on the production mesh.

The port of ``repro.launch.dryrun``. For an (architecture x input shape)
the step function runs once on the production mesh (``launch.mesh``:
16x16 ``("data", "model")`` single-pod, 2x16x16 ``("pod", "data",
"model")`` multi-pod) over torch's fake process group, from ``meta``
tensors: no storage is allocated, no kernel runs and nothing is
compiled. Each parameter is an ``nn.Parameter`` DTensor laid out by
``sharding.param_specs``, its local shard an empty ``meta`` tensor of
the shard's shape; the batch, cache and AdamW state are laid out by
``data_specs``, ``cache_specs`` and the parameters' specs. The real step
(``steps.build_train_step``, ``build_prefill_step``,
``build_serve_step``) runs under ``activation_rules`` with the JAX
package's logical map, and ``StepCost``, a dispatch mode under the
DTensors, sees rank 0's local operations:

* ``flops_per_device``: ``torch.utils.flop_counter``'s formulas over the
  local ops (matmuls, convolutions, attention);
* ``bytes_accessed_per_device``: operand + result bytes of every local
  aten op but views. Eager ops are not fused as XLA's are, so this is an
  upper bound of XLA's figure;
* ``collectives``: result bytes and counts of each functional collective
  the DTensors issue, under the JAX package's kind names (all-reduce,
  all-gather, reduce-scatter, all-to-all; any other under its own name).
  The fake group's mesh is a "cpu" mesh, on which DTensor runs an
  all-to-all as an all-gather and a chunk;
* ``memory``: ``argument_bytes`` (the local shards of the step's
  arguments), ``output_bytes`` and ``alias_bytes`` (what the step returns,
  and what of it it updates in place: the parameters and AdamW state of
  a train step, the cache of a decode step, as the JAX package donates
  them), ``temp_bytes`` (the peak of live local bytes made during the
  step, each storage followed to its last reference by weakref
  finalizers, less the fresh outputs), and ``peak_per_device`` formed as
  the JAX package forms it.

``compile_s`` holds the seconds of the meta run: there is no compile.
With M microbatches the train step runs the first microbatch's forward
and backward alone and counts them M times (the M slices have one
shape), then the AdamW update once; ``--full-loop`` runs all M.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k [--multi-pod] [--out experiments/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --table experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import weakref

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import ARCH_IDS, SHAPES, get_config, get_smoke
from ..sharding.act import activation_rules, contiguous_stride
from ..sharding.specs import (axis_sizes, batch_axes, cache_specs, data_specs,
                              param_specs, to_placements)
from . import steps as steps_mod
from .mesh import MULTI_POD_AXES, fake_mesh

# the functional collectives' names -> the JAX package's HLO kinds
COLLECTIVE_KINDS = {"all_reduce": "all-reduce",
                    "all_gather_into_tensor": "all-gather",
                    "reduce_scatter_tensor": "reduce-scatter",
                    "all_to_all_single": "all-to-all"}
# functional-collective ops that move nothing
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}
_FREE = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
         torch.ops.aten.empty_like.default}


def _tensors(tree) -> list:
    """The tensors in nested tuples, lists and dicts (a dispatch mode's
    arguments and results; faster than a pytree flatten)."""
    out, stack = [], [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            out.append(node)
        elif isinstance(node, (tuple, list)):
            stack.extend(node)
        elif isinstance(node, dict):
            stack.extend(node.values())
    return out


def _nbytes(t: torch.Tensor) -> int:
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()


class StepCost(TorchDispatchMode):
    """Counts one rank's local work: flops, bytes accessed, collectives and
    live bytes. An op on DTensors is left to DTensor (``NotImplemented``),
    whose local ops come back here; ops DTensor's sharding propagation
    runs under its fake mode (global shapes) are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.coll_bytes: dict = {}
        self.coll_counts: dict = {}
        self.scale = 1
        self.live: dict = {}          # storage key -> [bytes, references]
        self.current = 0
        self.peak = 0

    @contextlib.contextmanager
    def scaled(self, factor: int):
        """Count the work inside ``factor`` times (microbatches)."""
        prev, self.scale = self.scale, factor
        try:
            yield
        finally:
            self.scale = prev

    def _release(self, key) -> None:
        entry = self.live[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.current -= entry[0]
            del self.live[key]

    def _track(self, t: torch.Tensor, fresh: bool) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            self.live[key][1] += 1
        elif fresh:
            self.live[key] = [st.nbytes(), 1]
            self.current += st.nbytes()
            self.peak = max(self.peak, self.current)
        else:
            return
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            name = func._opname
            if name not in _NOT_COLLECTIVES:
                kind = COLLECTIVE_KINDS.get(name, name)
                self.coll_bytes[kind] = self.coll_bytes.get(kind, 0.0) \
                    + self.scale * sum(_nbytes(t) for t in outs)
                self.coll_counts[kind] = self.coll_counts.get(kind, 0) + self.scale
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += self.scale * flop_registry[packet](*args, **kwargs, out_val=out)
        view = func.is_view
        if not view and func not in _FREE:
            self.bytes_accessed += self.scale * sum(_nbytes(t) for t in ins + outs)
        in_ids = {id(t) for t in ins}
        for t in outs:
            self._track(t, fresh=not view and id(t) not in in_ids)
        return out

    def collectives(self) -> dict:
        return {"bytes": dict(self.coll_bytes), "counts": dict(self.coll_counts),
                "total_bytes": float(sum(self.coll_bytes.values()))}


@contextlib.contextmanager
def _memoized_redistribute_plans():
    """DTensor plans each redistribute anew, and on a 3-D mesh its
    planner's search takes most of a dry-run's time; the plan depends only
    on the source and target specs, so within a dry-run each pair is
    planned once. Where this torch has no such planner function the
    dry-run runs unmemoized."""
    from torch.distributed.tensor import _redistribute as r
    name = "_gen_transform_infos_non_cached"
    orig = getattr(r, name, None)
    if orig is None:
        yield
        return
    plans = {}

    def planned(src, dst, use_graph_based_transform=None):
        key = (src, dst, use_graph_based_transform)
        if key not in plans:
            plans[key] = orig(src, dst, use_graph_based_transform)
        return plans[key]
    setattr(r, name, planned)
    try:
        yield
    finally:
        setattr(r, name, orig)


def auto_microbatches(cfg, shape, mesh, *, stash_budget: float = 2**30) -> int:
    """Gradient-accumulation factor M: smallest power of two such that the
    per-device remat stash (n_layers x B/shards x S x d_model x 2B / seq_tp)
    fits the budget and B/M still divides the batch shards.
    REPRO_FORCE_MICRO overrides; REPRO_MOE_TRANSIENT_GB sets the MoE's
    transient budget (0.5 GiB)."""
    if os.environ.get("REPRO_FORCE_MICRO"):
        return int(os.environ["REPRO_FORCE_MICRO"])
    sizes = axis_sizes(mesh)
    dshards = 1
    for a in ("pod", "data"):
        n = sizes.get(a, 1)
        if shape.global_batch % (dshards * n) == 0:
            dshards *= n
    seq_shards = sizes.get("model", 1)
    stash = (cfg.n_layers * (shape.global_batch / dshards) * shape.seq_len
             * max(cfg.d_model, 1) * 2 / seq_shards)
    # MoE capacity dispatch inflates transient activations by ~k*cf copies
    # of the token stream at full d_model — budget those too
    transient = 0.0
    if cfg.n_experts:
        transient = (shape.global_batch / dshards * shape.seq_len
                     * cfg.n_experts_per_tok * cfg.capacity_factor
                     * cfg.d_model * 2)
    m = 1
    while ((stash / m > stash_budget
            or transient / m > float(os.environ.get("REPRO_MOE_TRANSIENT_GB", 0.5)) * 2**30)
           and (shape.global_batch // m) % dshards == 0
           and shape.global_batch // m > dshards and m < 32):
        m *= 2
    return m


def distribute_meta(t: torch.Tensor, mesh, spec: tuple, dtype=None) -> DTensor:
    """A DTensor of ``t``'s global shape laid out by ``spec`` on ``mesh``,
    its local shard an empty ``meta`` tensor of the shard's shape."""
    placements = to_placements(spec, mesh)
    local = list(t.shape)
    for j, p in enumerate(placements):
        if p.is_shard():
            if local[p.dim] % mesh.size(j):
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not split "
                                 f"{mesh.size(j)} ways (spec {spec})")
            local[p.dim] //= mesh.size(j)
    shard = torch.empty(local, dtype=dtype or t.dtype, device="meta")
    return DTensor.from_local(shard, mesh, placements, run_check=False,
                              shape=t.shape,
                              stride=contiguous_stride(t.shape))


def _distribute_tree(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _distribute_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_distribute_tree(v, s, mesh) for v, s in zip(tree, specs)]
    return distribute_meta(tree, mesh, specs)


def _distribute_model(model: nn.Module, specs: dict, mesh) -> None:
    """Each parameter replaced in place by its DTensor (``specs`` by
    dotted name)."""
    for prefix, mod in model.named_modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:
                full = f"{prefix}.{name}" if prefix else name
                mod._parameters[name] = nn.Parameter(
                    distribute_meta(p, mesh, specs[full]), requires_grad=p.requires_grad)


def _bytes_of(tree) -> int:
    return sum(_nbytes(t) for t in _tensors(tree))


def mesh_for(multi_pod: bool, mesh_shape=None) -> tuple:
    """(shape, axes, label) of the dry-run's mesh: the production meshes,
    or ``mesh_shape`` over the last of ("pod", "data", "model")."""
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh_shape = tuple(mesh_shape)
    axes = MULTI_POD_AXES[-len(mesh_shape):]
    return mesh_shape, axes, "x".join(str(n) for n in mesh_shape)


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               verbose: bool = True, lr: float = 3e-4, donate: bool = True,
               smoke: bool = False, mesh_shape=None,
               full_loop: bool = False) -> dict:
    """The cost report of one (arch, shape, mesh). ``smoke`` takes the
    arch's SMOKE config; ``mesh_shape`` another fake mesh; ``full_loop``
    runs every microbatch."""
    cfg = get_smoke(arch) if smoke else get_config(arch)
    shape = SHAPES[shape_name]
    dims, axes, label = mesh_for(multi_pod, mesh_shape)
    t0 = time.time()
    dp_only = os.environ.get("REPRO_DP_ONLY") == "1"
    micro = 1
    cost = StepCost()
    with fake_mesh(dims, axes) as mesh:
        model = steps_mod._meta_model(cfg)
        pspecs = param_specs(dict(model.named_parameters()), mesh,
                             tp="__no_tp__" if dp_only else "model")
        _distribute_model(model, pspecs, mesh)
        params = dict(model.named_parameters())
        if shape.kind == "train":
            moment = (torch.bfloat16 if os.environ.get("REPRO_OPT_DTYPE") == "bf16"
                      else torch.float32)
            opt = {"m": {k: distribute_meta(p, mesh, pspecs[k], moment)
                         for k, p in params.items()},
                   "v": {k: distribute_meta(p, mesh, pspecs[k], moment)
                         for k, p in params.items()},
                   "step": torch.zeros((), dtype=torch.int32)}
            batch = steps_mod.input_specs(arch, shape_name, cfg)
            batch = _distribute_tree(batch, data_specs(batch, mesh, shape.global_batch),
                                     mesh)
            micro = auto_microbatches(cfg, shape, mesh)
            fn = steps_mod.build_train_step(
                cfg, lr=lr, microbatches=micro,
                counted_micro=None if full_loop else lambda: cost.scaled(micro))
            args = (model, opt, batch)
        elif shape.kind == "prefill":
            batch = steps_mod.input_specs(arch, shape_name, cfg)
            batch = _distribute_tree(batch, data_specs(batch, mesh, shape.global_batch),
                                     mesh)
            fn = steps_mod.build_prefill_step(cfg, shape)
            args = (model, batch)
        else:                                        # decode
            spec = steps_mod.input_specs(arch, shape_name, cfg)
            cache = _distribute_tree(
                spec["cache"], cache_specs(spec["cache"], mesh, shape.global_batch),
                mesh)
            token = distribute_meta(spec["token"], mesh,
                                    data_specs(spec["token"], mesh, shape.global_batch))
            fn = steps_mod.build_serve_step(cfg)
            # the position: an int32 scalar as the JAX package's (the last
            # of the cache; shapes do not depend on it)
            pos = torch.tensor(steps_mod.cache_len_for(cfg, shape) - 1, dtype=torch.int32)
            args = (model, cache, token, pos)
        arg_bytes = _bytes_of(params) + _bytes_of(args[1:])

        sizes = axis_sizes(mesh)
        ba = batch_axes(mesh, shape.global_batch, include_model=dp_only)
        vocab_ax = None if dp_only else (
            "model" if cfg.vocab_size % sizes.get("model", 1) == 0 else None)
        # sequence-parallel residual stream for train (the JAX package's
        # measured choice); REPRO_NO_SEQTP=1 turns it off
        seq_tp = "model" if (shape.kind == "train"
                             and os.environ.get("REPRO_NO_SEQTP") != "1") else None
        if dp_only:
            seq_tp = None
        grad = torch.enable_grad() if shape.kind == "train" else torch.no_grad()
        with activation_rules(mesh, batch=ba, vocab=vocab_ax,
                              heads=None if dp_only else "model",
                              ff=None if dp_only else "model",
                              kv_seq="data", seq_tp=seq_tp), \
                implicit_replication(), _memoized_redistribute_plans(), grad, cost:
            out = fn(*args)
        if shape.kind == "train":
            _, opt, loss = out
            out_bytes = _bytes_of(params) + _bytes_of(opt) + _nbytes(loss)
            alias = (_bytes_of(params) + _bytes_of(opt)) if donate else 0
            fresh = _nbytes(loss)
        else:
            logits, cache_out = out
            out_bytes = _nbytes(logits) + _bytes_of(cache_out)
            alias = _bytes_of(cache_out) if (shape.kind == "decode" and donate) else 0
            fresh = out_bytes - (_bytes_of(cache_out) if shape.kind == "decode" else 0)
        n_dev = mesh.size()
    temp = max(cost.peak - fresh, 0)
    result = {
        "arch": arch, "shape": shape_name,
        "microbatches": micro if shape.kind == "train" else 1,
        "mesh": label,
        "n_devices": n_dev,
        "kind": shape.kind,
        "compile_s": round(time.time() - t0, 1),
        "flops_per_device": float(cost.flops),
        "bytes_accessed_per_device": float(cost.bytes_accessed),
        "collectives": cost.collectives(),
        "memory": {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(temp),
            "alias_bytes": int(alias),
            "peak_per_device": int(arg_bytes + out_bytes + temp - alias),
        },
    }
    if verbose:
        print(f"[dryrun] {arch:20s} {shape_name:12s} {result['mesh']:8s} "
              f"ok compile={result['compile_s']}s "
              f"peak/dev={result['memory']['peak_per_device'] / 2**30:.2f}GiB "
              f"flops/dev={result['flops_per_device']:.3e} "
              f"coll={result['collectives']['total_bytes'] / 2**20:.1f}MiB", flush=True)
    return result


def result_name(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}__{shape}__{'multi' if multi_pod else 'single'}.json".replace("/", "_")


def summary_table(out_dir: str) -> str:
    """A markdown table of every (arch, shape, mesh) of the sweep from the
    JSON files in ``out_dir``: ok or failed, M, argument, peak and
    collective GiB a device."""
    gib = 2.0 ** 30
    rows = ["| arch | shape | mesh | ok | M | argument GiB/dev | peak GiB/dev "
            "| collective GiB/dev |", "|---|---|---|---|---|---|---|---|"]
    for a in ARCH_IDS:
        for s in SHAPES:
            for mp in (False, True):
                path = os.path.join(out_dir, result_name(a, s, mp))
                mesh = "2x16x16" if mp else "16x16"
                if not os.path.exists(path):
                    rows.append(f"| {a} | {s} | {mesh} | failed | | | | |")
                    continue
                with open(path) as f:
                    r = json.load(f)
                m = r["memory"]
                rows.append(f"| {a} | {s} | {mesh} | ok | {r['microbatches']} "
                            f"| {m['argument_bytes'] / gib:.3f} "
                            f"| {m['peak_per_device'] / gib:.3f} "
                            f"| {r['collectives']['total_bytes'] / gib:.3f} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="sweep all arch x shape")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's SMOKE config (tests)")
    ap.add_argument("--mesh", default=None,
                    help="another fake mesh, e.g. 2x2 over (data, model)")
    ap.add_argument("--full-loop", action="store_true",
                    help="run every microbatch instead of counting one M times")
    ap.add_argument("--table", metavar="DIR",
                    help="print the sweep's markdown table from DIR's JSON files")
    args = ap.parse_args(argv)
    if args.table:
        print(summary_table(args.table))
        return

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        combos = [(args.arch, args.shape)]
    meshes = [False, True] if (args.both_meshes or (args.all and not args.multi_pod)) \
        else [args.multi_pod]
    mesh_shape = (tuple(int(n) for n in args.mesh.split("x"))
                  if args.mesh else None)

    failures = []
    for a, s in combos:
        for mp in meshes:
            try:
                res = dryrun_one(a, s, multi_pod=mp, smoke=args.smoke,
                                 mesh_shape=mesh_shape, full_loop=args.full_loop)
            except Exception as e:  # noqa: BLE001  (reported, and the exit fails)
                failures.append((a, s, mp, repr(e)[:200]))
                print(f"[dryrun] FAIL {a} {s} multi={mp}: {e}", flush=True)
                continue
            with open(os.path.join(args.out, result_name(a, s, mp)), "w") as f:
                json.dump(res, f, indent=1)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")


if __name__ == "__main__":
    main()
