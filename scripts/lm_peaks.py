"""Device memory of ``LMServer.generate`` on one card, for one tree.

    python scripts/lm_peaks.py [--tree DIR]

Imports ``chip_smoke.py`` and ``src`` of ``DIR`` (this checkout by default,
or e.g. a ``git archive`` of another commit, so that two trees are measured
by their own code in one run on one card), builds the kernels, and runs
that tree's ``chip_smoke.lm_phase`` for the three models whose prefill
keeps a cache per layer: mistral-nemo-12b (``transformer_config()``, its
``LM_BATCH`` x ``LM_PROMPT``, ``LM_STEPS``), mamba2-780m and zamba2-2.7b
(``MAMBA2``, ``ZAMBA2``).  Prints one JSON line per model with
``peak_memory_gb_init`` (the weights), ``peak_memory_gb_generate`` (the
most allocated from there through ``generate``, prefill included: the
``peak_memory_gb_generate`` of ``chip_smoke.py``'s ``ssm_lm`` lines), the
prefill ms and a digest of the tokens, then the card's name and power limit.
Needs one card.
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
        print("lm_peaks: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build_kernels()
    runs = (("mistral-nemo-12b", cs.transformer_config(), cs.LM_BATCH, cs.LM_PROMPT, cs.LM_STEPS),
            (cs.MAMBA2[0], get_config(cs.MAMBA2[0]), *cs.MAMBA2[1:]),
            (cs.ZAMBA2[0], get_config(cs.ZAMBA2[0]), *cs.ZAMBA2[1:]))
    for arch, cfg, batch, prompt, steps in runs:
        res = cs.lm_phase(device, cfg, batch, prompt, steps, check_batch=1)
        print(json.dumps({"lm_peaks": {
            "tree": str(tree), "arch": arch, "layers": cfg.num_layers, "batch": batch,
            "prompt": prompt, "steps": steps, "peak_memory_gb_init": res["init_gb"],
            "peak_memory_gb_generate": res["generate_gb"], "prefill_ms": res["prefill_ms"],
            "tokens_sha1": hashlib.sha1(res["tokens"].tobytes()).hexdigest()}}), flush=True)
        del res
        cs.free_memory()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
