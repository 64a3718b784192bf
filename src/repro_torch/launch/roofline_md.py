"""Render the roofline markdown table from the port's dry-run JSON, the port
of ``scripts/make_roofline_md.py``.

    PYTHONPATH=src python -m repro_torch.launch.roofline_md [DIR]

``DIR`` defaults to :data:`repro_torch.launch.dryrun.DEFAULT_OUT`, where
``python -m repro_torch.launch.dryrun`` writes.  One row per (arch, shape,
mesh): the policy, the three roofline terms in seconds (H100 rates), the
dominant one, model FLOPs over counted FLOPs and the parameters.
"""
from __future__ import annotations

import glob
import json
import os
import sys
from typing import Dict, List, Tuple

from repro_torch.launch.dryrun import DEFAULT_OUT


def rows(d: str) -> Dict[Tuple[str, str, str], dict]:
    out = {}
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def table(d: str = DEFAULT_OUT) -> List[str]:
    """The table's lines."""
    lines = ["| arch | shape | mesh | policy | t_compute (s) | t_memory (s) | "
             "t_collective (s) | dominant | MODEL/counted FLOPs | params (B) |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for (a, s, m), r in sorted(rows(d).items()):
        if r["status"] == "skipped":
            lines.append(f"| {a} | {s} | {m} | — | — | — | — | skipped ({r['reason'][:40]}…) "
                         "| — | — |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {a} | {s} | {m} | — | — | — | — | error ({r['error'][:40]}…) "
                         "| — | — |")
            continue
        lines.append(
            f"| {a} | {s} | {m} | {r['policy']} | {r['t_compute']:.4f} | "
            f"{r['t_memory']:.3f} | {r['t_collective']:.3f} | {r['dominant']} | "
            f"{r['useful_flops_ratio']:.3f} | {r['n_params'] / 1e9:.2f} |"
        )
    return lines


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    print("\n".join(table(argv[0] if argv else DEFAULT_OUT)))


if __name__ == "__main__":
    main()
