"""Multi-pod dry-run, the counterpart of ``repro/launch/dryrun.py``: count
every (architecture x input shape) cell's step on the production meshes
and record its roofline terms (``launch/analysis.py``).

The reference forces 512 host devices and compiles each step.  The port
initialises a ``fake`` process group (torch's ``FakeStore``: no process
stands behind the other ranks, and every collective returns at once) as
rank 0 of 256 (16x16) or 512 (2x16x16) ranks, builds the mesh through
``make_production_mesh``, places params, optimizer state, caches and
batches as fake DTensors of their abstract shapes, and counts one step of
rank 0 (``analysis.count_step``).  The fake group is the default process
group, so the dry-run runs in a process of its own; it touches no card,
and its records say ``"device": "fake"``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl
Options: --multi-pod (2x16x16 mesh), --routing {direct,coordinator},
         --[no-]seq-parallel, --moe-impl, --set KEY=VALUE, --microbatches,
         --tag, --print-hlo (the counted aten ops, the port's lowered form)
"""
import argparse
import dataclasses
import json
import sys
import time
import traceback

import torch

from ..configs import ARCHS, LM_SHAPES, get_config, get_shape, shape_applicable
from ..nn.layers import leaves, map_defs
from ..parallel import sharding as sh
from ..train import serve as serve_lib
from ..train import trainer as trainer_lib
from ..train.optimizer import OptConfig, init_opt_state
from . import analysis
from .mesh import make_production_mesh


def init_fake_world(world: int) -> None:
    """Make the default process group a ``fake`` one of ``world`` ranks,
    this process rank 0 (as it is already, where it is)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError(f"the process group is {dist.get_backend()} "
                               f"of {dist.get_world_size()} ranks; the "
                               f"dry-run needs a fake one of {world}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def input_specs(cfg, shape, rules):
    """Stand-ins (shape, dtype, sharding) for every model input of this
    cell."""
    if shape.mode == "train":
        return trainer_lib.batch_specs(cfg, shape, rules)
    return serve_lib.serve_batch_specs(cfg, shape.global_batch, shape.seq_len,
                                       rules)


def _placed(tree):
    """Fake DTensors of a tree of stand-ins (``sh.Sds``), each placed by
    its sharding (to be called under a FakeTensorMode)."""
    return map_defs(lambda s: sh.shard_tensor(
        torch.empty(s.shape, dtype=s.dtype), s.sharding), tree)


def _whole(tree):
    """Fake tensors of a tree of stand-ins, whole: the global batch, which
    the port's steps take alike on every rank."""
    return map_defs(lambda s: torch.empty(s.shape, dtype=s.dtype), tree)


def _local_bytes(tree) -> int:
    return sum(sh.local(t).numel() * sh.local(t).element_size()
               for t in leaves(tree) if isinstance(t, torch.Tensor))


def lower_cell(cfg, shape, mesh, routing: str = "direct",
               seq_parallel: bool = True, microbatches: int = 1):
    """Build one (arch x shape x mesh) cell's step and its fake inputs and
    count it on this rank.  Returns (totals, n_chips); the totals'
    ``arg_bytes`` are this rank's bytes of params, state, cache and
    batch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    n_chips = mesh.size()
    with FakeTensorMode(allow_non_fake_inputs=True):
        if shape.mode == "train":
            opts = trainer_lib.TrainOptions(routing=routing,
                                            seq_parallel=seq_parallel,
                                            microbatches=microbatches)
            step = trainer_lib.make_train_step(cfg, OptConfig(), opts,
                                               mesh=mesh)
            params = _placed(trainer_lib.abstract_train_state(
                cfg, step.rules)[0])
            args = (params, init_opt_state(params),
                    _whole(input_specs(cfg, shape, step.rules)))
        else:
            make = serve_lib.make_prefill_step if shape.mode == "prefill" \
                else serve_lib.make_decode_step
            b, s = shape.global_batch, shape.seq_len
            step = make(cfg, b, s, mesh=mesh, routing=routing)
            params = _placed(serve_lib.abstract_serve_params(cfg,
                                                             step.rules)[0])
            cache = serve_lib.place_cache(cfg, step.rules, b, s)
            if shape.mode == "prefill":
                inputs = _whole(input_specs(cfg, shape, step.rules))
            else:
                # one new token against a full seq_len cache
                cache["pos"] = s - 1
                inputs = torch.empty((b, 1), dtype=torch.int32)
            args = (params, cache, inputs)
        arg_bytes = _local_bytes(args)
        totals = analysis.count_step(step, *args)
    totals.arg_bytes = arg_bytes
    return totals, n_chips


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             routing: str = "direct", seq_parallel: bool = True,
             print_hlo: bool = False, moe_impl: str | None = None,
             overrides: dict | None = None, microbatches: int = 1) -> dict:
    cfg = get_config(arch)
    if moe_impl and cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    if overrides:
        typed = {k: type(getattr(cfg, k))(v) for k, v in overrides.items()}
        cfg = dataclasses.replace(cfg, **typed)
    shape = get_shape(shape_name)
    ok, why = shape_applicable(cfg, shape)
    mesh_desc = "2x16x16" if multi_pod else "16x16"
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_desc,
            "routing": routing, "seq_parallel": seq_parallel,
            "moe_impl": cfg.moe_impl if cfg.n_experts else None,
            "device": "fake"}
    if not ok:
        return {**base, "status": "skipped", "reason": why}
    init_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    t0 = time.time()
    try:
        totals, n_chips = lower_cell(cfg, shape, mesh, routing, seq_parallel,
                                     microbatches=microbatches)
        t_count = time.time() - t0
        if print_hlo:
            for name, n in totals.ops.most_common():
                print(f"  {n:9d}  {name}")
        rep = analysis.summarize(totals, cfg, shape, mesh_desc, n_chips)
        print(f"[dryrun] {arch} x {shape_name} @ {mesh_desc} "
              f"({routing}): COUNTED in {t_count:.1f}s")
        print(f"  args/dev={totals.arg_bytes / 2**30:.2f}GiB "
              f"peak live/dev={rep.peak_mem_bytes / 2**30:.2f}GiB")
        print(f"  counts: flops/dev={rep.flops:.3e} "
              f"bytes/dev={rep.hbm_bytes:.3e}")
        print("  collectives/dev: " + (", ".join(
            f"{k}={v / 2**20:.1f}MiB"
            for k, v in sorted(rep.coll_bytes.items())) or "none"))
        print(f"  roofline: t_comp={rep.t_compute * 1e3:.2f}ms "
              f"t_mem={rep.t_memory * 1e3:.2f}ms "
              f"t_coll={rep.t_collective * 1e3:.2f}ms "
              f"-> {rep.bottleneck}-bound, frac={rep.roofline_frac:.3f}")
        out = {k: v for k, v in rep.to_dict().items()
               if not k.startswith("xla_")}
        return {**base, "status": "ok", "t_count_s": t_count, **out,
                "mem": {"argument": totals.arg_bytes,
                        "peak_live": rep.peak_mem_bytes}}
    except Exception as e:  # noqa: BLE001 — a failed cell is a recorded bug
        traceback.print_exc()
        return {**base, "status": "failed",
                "error": f"{type(e).__name__}: {e}"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None,
                    choices=[s.name for s in LM_SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--routing", default="direct",
                    choices=["direct", "coordinator"])
    ap.add_argument("--seq-parallel", dest="seq_parallel",
                    action="store_true", default=True)
    ap.add_argument("--no-seq-parallel", dest="seq_parallel",
                    action="store_false")
    ap.add_argument("--moe-impl", default=None, choices=["einsum", "gather"])
    ap.add_argument("--print-hlo", action="store_true",
                    help="print the counted aten ops of each cell")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE", help="override a ModelConfig field")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default=None, help="label recorded in the JSONL")
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in getattr(args, "set"))

    cells = []
    if args.all:
        for a in ARCHS:
            for s in LM_SHAPES:
                cells.append((a, s.name))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        res = run_cell(arch, shape, multi_pod=args.multi_pod,
                       routing=args.routing, seq_parallel=args.seq_parallel,
                       print_hlo=args.print_hlo, moe_impl=args.moe_impl,
                       overrides=overrides, microbatches=args.microbatches)
        if args.tag:
            res["tag"] = args.tag
        if res["status"] == "failed":
            failures += 1
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(res) + "\n")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
