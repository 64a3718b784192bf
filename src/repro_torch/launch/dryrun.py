"""Multi-pod dry run on the CPU, the PyTorch port of ``repro.launch.dryrun``.

The reference lowers and compiles each (architecture x input shape) step on
the production meshes of 512 forced host devices and writes XLA's memory
and cost analyses and the roofline terms.  The port has no compiler to ask:
it runs the step once, on ``meta`` tensors, in a fake world of 256 ranks
(the 16 x 16 single-pod mesh) or 512 (2 x 16 x 16), as rank 0 — parameters,
optimizer state and caches placed as ``DTensor``s by the plan
(:func:`repro_torch.launch.specs.make_plan`), every collective a no-op of
the fake process group, every hand kernel's meta path launching nothing —
under :func:`repro_torch.launch.op_cost.analyze_step`, and writes the
reference's JSON.  No GPU, no values, no memory beyond the shapes.

Its fields are the reference's, with FLOPs and bytes counted on rank 0 and
multiplied by the ranks as the reference multiplies its per-device HLO
counts, except where the compiler's fields have no counterpart:
``lower_s`` and ``compile_s`` become ``trace_s`` (the step's one run);
``memory_analysis`` becomes ``memory`` — ``argument_bytes`` (rank 0's shards
of the parameters, optimizer state and cache, and the inputs every rank
holds), ``output_bytes`` (its shards of what the step returns) and
``peak_bytes`` (the arguments plus the most bytes the step allocated and
held at once, tracked per local tensor); there is no ``cost_analysis``.
``kernels`` gives each hand kernel's counted launches, FLOPs and bytes.
With ``world_of_one`` (``--world-of-one``) the same plan is counted once
more in a fake world of one rank on a (1, 1) mesh — the whole step's work,
which the mesh's ranks should share — and the JSON adds ``world_of_one``
(its FLOPs and peak bytes) and ``flops_factor``, the mesh's ``hlo_flops``
over that count.

:func:`fake_world` is this package's only use of
``torch.testing._internal.distributed.fake_pg``, an internal API.
Importing this module makes no process group.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-34b \\
      --shape train_4k --mesh single --out reports/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every combo, serial
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, list_archs
from repro_torch.launch.mesh import make_mesh, make_production_mesh, set_mesh
from repro_torch.launch.op_cost import analyze_step, local_bytes
from repro_torch.launch.roofline import (
    RooflineReport, active_params, collective_totals, model_flops_estimate,
)
from repro_torch.launch.specs import config_for_shape, make_plan, shape_supported
from repro_torch.models.config import INPUT_SHAPES, get_shape
from repro_torch.sharding.utils import tree_bytes

#: Where the dry run writes, beside the reference's ``reports/dryrun``.
DEFAULT_OUT = "reports/dryrun_torch"


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0) -> Iterator[None]:
    """A fake process group of ``world_size`` ranks, this process being
    ``rank``, for the ``with`` body: meshes build over it and collectives
    return at once without moving data.  Refuses to start where a process
    group already exists (it never stands in for a real world), and
    destroys its group on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group already exists: a fake world cannot join it")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _record(arch: str, shape: str, mesh: str, **fields) -> dict:
    return {"arch": arch, "shape": shape, "mesh": mesh, **fields}


def run_one(
    arch: str,
    shape_name: str,
    mesh_kind: str = "single",
    policy: str = "auto",
    out_dir: Optional[str] = None,
    verbose: bool = True,
    world_of_one: bool = False,
) -> dict:
    """One dry run of ``arch`` at ``shape_name`` on the ``mesh_kind``
    production mesh, in a fake world of its own: the result dict, also
    written to ``out_dir`` as ``<arch>__<shape>__<mesh>.json``.  With
    ``world_of_one`` the plan is also counted in a world of one
    (:func:`count_world_of_one`)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, why = shape_supported(config_for_shape(cfg, shape), shape)
    if not ok:
        result = _record(arch, shape_name, mesh_kind, status="skipped", reason=why)
        _write(result, out_dir, arch, shape_name, mesh_kind)
        return result

    chips = 512 if mesh_kind == "multi" else 256
    t0 = time.perf_counter()
    try:
        with fake_world(chips):
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device="cpu")
            with set_mesh(mesh):
                plan = make_plan(cfg, shape, mesh, policy)
                t_plan = time.perf_counter()
                acc = analyze_step(plan.step_fn, *plan.args)
                t_trace = time.perf_counter() - t_plan
                arg_bytes = local_bytes(plan.args)
        one = count_world_of_one(cfg, shape, plan.policy) if world_of_one else None
    except Exception as e:  # a failed run is a bug: surface it
        result = _record(arch, shape_name, mesh_kind, status="error",
                         error=f"{type(e).__name__}: {e}",
                         traceback=traceback.format_exc()[-4000:])
        _write(result, out_dir, arch, shape_name, mesh_kind)
        if verbose:
            print(json.dumps({k: result[k] for k in ("arch", "shape", "mesh", "status", "error")}))
        return result

    coll = collective_totals({k[len("coll_"):]: v for k, v in acc.items()
                              if k.startswith("coll_")})
    n_params = int(tree_bytes(plan.args[0]) / plan.cfg.params_dtype().itemsize)
    n_active = active_params(plan.cfg, n_params)
    mf = model_flops_estimate(plan.cfg, shape, n_params, n_active)
    memory = {"argument_bytes": float(arg_bytes), "output_bytes": float(acc["output_bytes"]),
              "peak_bytes": float(arg_bytes + acc["peak_bytes"])}
    report = RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_kind, chips=chips,
        hlo_flops=acc["flops"] * chips, hlo_bytes=acc["bytes"] * chips,
        coll_bytes=coll["total"], coll_breakdown=coll,
        model_flops=mf,
        bytes_per_device=memory["argument_bytes"],
        peak_memory_per_device=memory["peak_bytes"],
    )
    result = {
        "status": "ok",
        "kind": plan.kind,
        "policy": plan.policy.name,
        "n_params": n_params,
        "n_active_params": n_active,
        "trace_s": round(t_trace, 1),
        "memory": memory,
        "kernels": acc["kernels"],
        **report.to_dict(),
    }
    if one is not None:
        result["world_of_one"] = one
        result["flops_factor"] = result["hlo_flops"] / one["flops"]
    _write(result, out_dir, arch, shape_name, mesh_kind)
    if verbose:
        print(json.dumps({
            "arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "status": "ok", "policy": plan.policy.name,
            "params_B": round(n_params / 1e9, 2),
            "t_compute": f"{report.t_compute:.4f}",
            "t_memory": f"{report.t_memory:.4f}",
            "t_collective": f"{report.t_collective:.4f}",
            "dominant": report.dominant,
            "useful": f"{report.useful_flops_ratio:.3f}",
            "trace_s": result["trace_s"],
            "total_s": round(time.perf_counter() - t0, 1),
        }), flush=True)
    return result


def count_world_of_one(cfg, shape, policy) -> dict:
    """The FLOPs and peak bytes (arguments included) of the plan of ``cfg``
    at ``shape`` under ``policy``, counted in a fake world of one rank on a
    (1, 1) ``(data, model)`` mesh: the work that a mesh's ranks share."""
    with fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        with set_mesh(mesh):
            plan = make_plan(cfg, shape, mesh, policy)
            acc = analyze_step(plan.step_fn, *plan.args)
            return {"flops": acc["flops"],
                    "peak_bytes": float(local_bytes(plan.args) + acc["peak_bytes"])}


def _write(result: dict, out_dir: Optional[str], arch: str, shape: str, mesh: str) -> None:
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=2)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=[s.name for s in INPUT_SHAPES])
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--policy", choices=["auto", "tp", "fsdp_tp", "expert_tp", "fsdp_expert"],
                    default="auto")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--all", action="store_true", help="run every combo serially")
    ap.add_argument("--world-of-one", action="store_true",
                    help="also count the plan in a world of one rank")
    args = ap.parse_args(argv)

    torch.set_num_threads(1)  # meta tensors compute nothing
    if args.all:
        for arch in list_archs():
            for shape in INPUT_SHAPES:
                for mesh in ("single", "multi"):
                    run_one(arch, shape.name, mesh, args.policy, args.out,
                            world_of_one=args.world_of_one)
        return
    if not args.arch or not args.shape:
        ap.error("--arch and --shape are required (or use --all)")
    run_one(args.arch, args.shape, args.mesh, args.policy, args.out,
            world_of_one=args.world_of_one)


if __name__ == "__main__":
    main()
