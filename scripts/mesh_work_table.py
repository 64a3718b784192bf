"""Each rank's share of the work on the 16 x 16 production mesh, on the CPU.

    PYTHONPATH=src python scripts/mesh_work_table.py --out DIR [--parent SRC] [--jobs 3]

For every runnable (arch, shape) pair of the single-pod mesh, under the
port's own policy (``repro_torch.launch.specs.select_policy``), this runs:

* the port's dry run with ``--world-of-one`` (``python -m
  repro_torch.launch.dryrun``): ``hlo_flops`` over the 256 ranks, the same
  plan's FLOPs counted in a world of one, and the peak bytes of a rank;
* the reference's dry run under the same policy (``python -m
  repro.launch.dryrun --policy P``, ``JAX_PLATFORMS=cpu``, 512 forced
  host devices): its ``hlo_flops`` and ``peak_memory_per_device``;
* with ``--parent SRC`` (the ``src`` of another tree, e.g. ``git archive``
  of the parent commit), that tree's dry run of the port as well.

It prints a markdown table and the pairs that break either criterion:
``hlo_flops`` above 1.10 times the larger of the world-of-one count and
the reference's, or (``train_4k``) a peak above 1.5 times the
reference's.  All numbers are CPU counts on meta tensors and compiled HLO,
not times or memory of any device.  The JSONs land under ``DIR/port``,
``DIR/reference`` and ``DIR/parent``; a pair already there is not run
again.  Runs take 2-30 s each.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FLOPS_SLACK = 1.10
PEAK_SLACK = 1.5


def pairs() -> list:
    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch.specs import config_for_shape, select_policy, shape_supported
    from repro_torch.models.config import INPUT_SHAPES

    out = []
    for arch in list_archs():
        for shape in INPUT_SHAPES:
            cfg = config_for_shape(get_config(arch), shape)
            if shape_supported(cfg, shape)[0]:
                out.append((arch, shape.name, select_policy(cfg, shape).name))
    return out


def _run(module: str, src: str, arch: str, shape: str, policy: str, out: str,
         extra=(), env_extra=None) -> dict:
    path = os.path.join(out, f"{arch}__{shape}__single.json")
    if not os.path.exists(path):
        env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1", **(env_extra or {}))
        subprocess.run([sys.executable, "-m", module, "--arch", arch, "--shape", shape,
                        "--mesh", "single", "--policy", policy, "--out", out, *extra],
                       env=env, cwd=ROOT, capture_output=True, timeout=1800)
    try:
        with open(path) as fh:
            return json.load(fh)
    except FileNotFoundError:
        return {"status": "missing"}


def _g(x) -> str:
    return "—" if x is None else f"{x:.4g}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--parent", help="the src directory of another tree, run as 'before'")
    ap.add_argument("--jobs", type=int, default=3)
    args = ap.parse_args(argv)
    src = str(ROOT / "src")
    ref_env = {"JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    todo = pairs()

    def one(pair):
        arch, shape, policy = pair
        row = {"port": _run("repro_torch.launch.dryrun", src, arch, shape, policy,
                            os.path.join(args.out, "port"), ("--world-of-one",)),
               "ref": _run("repro.launch.dryrun", src, arch, shape, policy,
                           os.path.join(args.out, "reference"), env_extra=ref_env)}
        if args.parent:
            row["parent"] = _run("repro_torch.launch.dryrun", args.parent, arch, shape, policy,
                                 os.path.join(args.out, "parent"))
        return pair, row

    with ThreadPoolExecutor(args.jobs) as ex:
        rows = list(ex.map(one, todo))
    print("| pair (policy) | port before | port | world of one | reference | port / max(one, ref) "
          "| peak GB before | peak GB | reference peak GB |")
    print("|---|---|---|---|---|---|---|---|---|")
    bad = []
    for (arch, shape, policy), row in rows:
        port, ref, parent = row["port"], row["ref"], row.get("parent", {})
        if port.get("status") != "ok" or ref.get("status") != "ok":
            bad.append((arch, shape, port.get("error") or port.get("status"),
                        ref.get("error") or ref.get("status")))
            continue
        one = port["world_of_one"]["flops"]
        factor = port["hlo_flops"] / max(one, ref["hlo_flops"])
        peak, rpeak = port["peak_memory_per_device"], ref["peak_memory_per_device"]
        ppeak = parent.get("peak_memory_per_device")
        if factor > FLOPS_SLACK or (shape == "train_4k" and peak > PEAK_SLACK * rpeak):
            bad.append((arch, shape, factor, peak / rpeak))
        print(f"| {arch} `{shape}` ({policy}) | {_g(parent.get('hlo_flops'))} | "
              f"{port['hlo_flops']:.4g} | {one:.4g} | {ref['hlo_flops']:.4g} | {factor:.3f} | "
              f"{'—' if ppeak is None else f'{ppeak / 1e9:.1f}'} | {peak / 1e9:.1f} | "
              f"{rpeak / 1e9:.1f} |")
    print(json.dumps({"pairs": len(rows), "over": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
