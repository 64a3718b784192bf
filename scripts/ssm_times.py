"""Prefill and train step times of the SSM and hybrid models on one card,
for one tree.

    python scripts/ssm_times.py [--tree DIR]

Imports ``chip_smoke.py`` and ``src`` of ``DIR`` (this checkout by default,
or e.g. a ``git archive`` of another commit, so that two trees are measured
by their own code in one run on one card), builds the kernels, and for
mamba2-780m and zamba2-2.7b runs that tree's ``chip_smoke.lm_phase`` at
``MAMBA2`` / ``ZAMBA2`` (the prefill ms and the tokens of ``chip_smoke.py``'s
``ssm_lm`` lines) and ``chip_smoke.train_steps`` at ``TRAIN_SSMS`` (the
median step ms after the first, ``steady_step_ms`` of its ``train_ssm``
lines).  Prints one JSON line per model and then the card's name and power
limit.  Needs one card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import torch

    if not torch.cuda.is_available():
        print("ssm_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.models.registry import get_model

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build_kernels()
    train = {arch: rest for arch, *rest in cs.TRAIN_SSMS}
    for arch, batch, prompt, steps in (cs.MAMBA2, cs.ZAMBA2):
        cfg = get_config(arch)
        res = cs.lm_phase(device, cfg, batch, prompt, steps, check_batch=1)
        row = {"tree": str(tree), "arch": arch, "layers": cfg.num_layers,
               "prefill": {"batch": batch, "prompt": prompt, "ms": res["prefill_ms"],
                           "tokens_sha1": hashlib.sha1(res["tokens"].tobytes()).hexdigest()}}
        del res
        cs.free_memory()
        tbatch, seq, tsteps = train[arch]
        model = get_model(cfg)
        params = model.init(torch.Generator(device=device).manual_seed(0), device)
        it = lm_batches(cfg.vocab_size, tbatch, seq, seed=0)
        run = cs.train_steps(device, model, params, [next(it) for _ in range(tsteps + 1)], tsteps)
        row["train"] = {"batch": tbatch, "seq": seq, "steps": tsteps, "remat": cfg.remat,
                        "step_ms": run["step_ms"], "steady_step_ms": run["steady_ms"],
                        "losses": run["losses"], "busy": run["breakdown"]["busy"]}
        del params, run
        cs.free_memory()
        print(json.dumps({"ssm_times": row}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
