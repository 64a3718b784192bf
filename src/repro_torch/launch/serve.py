"""Serving launcher: batched prefill + greedy decode for any arch of the zoo.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      [--smoke] [--batch 4] [--prompt-len 16] [--steps 16] [--device cpu] \\
      [--production-mesh]

Random weights from a seeded ``torch.Generator`` (drawn on the card when the
device is CUDA), random prompts from numpy with the same seed (and, for the
enc-dec family, (batch, prompt-len, enc_inputs) normal frontend features
from the same numpy generator, as the reference's launcher makes them), one
``LMServer.generate``; prints the tokens per second, timed after a CUDA
synchronise, and a sample.  Runs on ``cuda`` unless ``--device`` names
another.

As the reference's launcher, it serves under a mesh and ``TP_POLICY``: the
one-device ``(1, 1)`` host mesh by default, the 16 x 16 production mesh
under ``--production-mesh`` (which needs a world of 256 ranks, e.g.
``torchrun --nproc-per-node ...``; any other world raises).  The params
are placed by ``fit_specs(params, model.param_specs(policy), mesh)``.
Without a process group it starts and ends a world of one
(:func:`~repro_torch.launch.mesh.launcher_world`).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.launch.mesh import launcher_world, make_host_mesh, make_production_mesh, set_mesh
from repro_torch.models.registry import get_model
from repro_torch.serving import LMServer
from repro_torch.sharding.policy import TP_POLICY
from repro_torch.sharding.utils import place_tree


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    """Parse ``argv`` (the command line when None), serve, print; returns the
    generated tokens (B, steps)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list_archs(), default="granite-34b")
    ap.add_argument("--smoke", action="store_true", help="the reduced same-family config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 (data, model) mesh (needs 256 ranks)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    with launcher_world(device.type):
        mesh = (make_production_mesh(device=device.type) if args.production_mesh
                else make_host_mesh(device=device.type))
        with set_mesh(mesh):
            return _serve(args, cfg, device, mesh)


def _serve(args: argparse.Namespace, cfg, device: torch.device, mesh) -> np.ndarray:
    model = get_model(cfg)
    gen_device = device if device.type == "cuda" else torch.device("cpu")
    params = model.init(torch.Generator(device=gen_device).manual_seed(args.seed), device)
    params = place_tree(params, model.param_specs(TP_POLICY), mesh)
    server = LMServer(model, params, TP_POLICY)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.raw_vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    feats = None
    if cfg.family == "encdec":
        feats = rng.normal(size=(args.batch, args.prompt_len, cfg.enc_inputs)).astype(np.float32)
    _sync(device)
    t0 = time.perf_counter()  # monotonic: NTP can step time.time()
    out = server.generate(prompts, steps=args.steps, features=feats)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} device={device} generated {out.shape[0]}x{out.shape[1]} tokens "
          f"in {dt:.3f}s ({out.size / dt:.1f} tok/s)", flush=True)
    print("sample:", out[0][:16], flush=True)
    return out


if __name__ == "__main__":
    main()
