"""Training launcher: AdamW steps of any arch of the zoo on synthetic tokens.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mistral-nemo-12b \\
      [--smoke] [--steps 100] [--batch 8] [--seq 128] [--lr 3e-4] \\
      [--ckpt PATH] [--device cpu] [--production-mesh]

The counterpart of ``repro.launch.train``: params from ``init`` (a seeded
``torch.Generator``, drawn on the card when the device is CUDA), AdamW with
a warmup of ``max(steps // 10, 1)`` steps and a cosine decay over
``--steps``, ``lm_batches(seed=0)`` token batches and, for the enc-dec
family, (batch, seq, enc_inputs) normal features drawn from
``np.random.default_rng(step)`` at each step.  Prints the reference's
``step … loss … lr … gnorm`` line every 10 steps and at the last, then the
step time and tokens per second (after a CUDA synchronise), and saves
``{"params": ...}`` to ``--ckpt`` (each leaf whole).  Runs on ``cuda``
unless ``--device`` names another.

As the reference's launcher, it trains under a mesh and ``TP_POLICY``: the
one-device ``(1, 1)`` host mesh by default, the 16 x 16 production mesh
under ``--production-mesh`` (a world of 256 ranks, e.g. ``torchrun
--nproc-per-node ...``; any other world raises).  The params are placed by
``fit_specs(params, model.param_specs(policy), mesh)``, and the train step
runs on the mesh.  Without a process group it starts and ends a world of
one (:func:`~repro_torch.launch.mesh.launcher_world`).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device, tree_map
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data import lm_batches
from repro_torch.launch.mesh import launcher_world, make_host_mesh, make_production_mesh, set_mesh
from repro_torch.models.registry import get_model
from repro_torch.sharding.policy import TP_POLICY
from repro_torch.sharding.utils import is_dtensor, place_tree
from repro_torch.training import AdamWConfig, adamw_init, make_train_step, save_checkpoint


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None, params: Any = None) -> Dict[str, Any]:
    """Parse ``argv`` (the command line when None), train, print.  ``params``
    replaces the seeded init (a test starts from the reference's weights).
    Returns ``{"params", "opt", "history"}``, the history one dict of
    ``loss``, ``lr`` and ``grad_norm`` floats per step.  The params and
    moments are ``DTensor``s where the caller owns the process group;
    where ``main`` made it (and ended it) each is this rank's shard as a
    plain tensor — the whole tensor on the host mesh."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list_archs(), default="granite-34b")
    ap.add_argument("--smoke", action="store_true", help="the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None, help="checkpoint path to save")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 (data, model) mesh (needs 256 ranks)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    with launcher_world(device.type) as made_here:
        mesh = (make_production_mesh(device=device.type) if args.production_mesh
                else make_host_mesh(device=device.type))
        with set_mesh(mesh):
            out = _train(args, cfg, device, mesh, params)
    if made_here:
        # The group is gone: hand back each rank's shards as plain tensors.
        local = lambda t: t.to_local() if is_dtensor(t) else t  # noqa: E731
        out = {**out, "params": tree_map(local, out["params"]), "opt": tree_map(local, out["opt"])}
    return out


def _train(args: argparse.Namespace, cfg, device: torch.device, mesh, params: Any) -> Dict[str, Any]:
    policy = TP_POLICY
    model = get_model(cfg)
    if params is None:
        gen_device = device if device.type == "cuda" else torch.device("cpu")
        params = model.init(torch.Generator(device=gen_device).manual_seed(0), device)
    params = place_tree(params, model.param_specs(policy), mesh)
    opt = adamw_init(params)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, policy)
    it = lm_batches(cfg.vocab_size, args.batch, args.seq, seed=0)

    history: List[Dict[str, float]] = []
    _sync(device)
    t0 = time.perf_counter()
    for step in range(args.steps):
        tokens = next(it)
        if cfg.family == "encdec":
            feats = np.random.default_rng(step).normal(
                size=(args.batch, args.seq, cfg.enc_inputs)
            ).astype(np.float32)
            batch = {"features": feats, "tokens": tokens}
        else:
            batch = tokens
        params, opt, metrics = step_fn(params, opt, batch)
        history.append({"loss": float(metrics["loss"]), "lr": float(metrics["lr"]),
                        "grad_norm": float(metrics["grad_norm"])})
        if step % 10 == 0 or step == args.steps - 1:
            m = history[-1]
            print(f"step {step:4d} loss {m['loss']:.4f} lr {m['lr']:.2e} "
                  f"gnorm {m['grad_norm']:.3f} ({time.perf_counter() - t0:.0f}s)", flush=True)
    _sync(device)
    seconds = time.perf_counter() - t0
    print(f"arch={cfg.name} device={device} {args.steps} steps of {args.batch}x{args.seq} "
          f"tokens in {seconds:.3f}s ({seconds / max(args.steps, 1) * 1e3:.1f} ms/step, "
          f"{args.steps * args.batch * args.seq / seconds:.1f} tok/s)", flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, {"params": params}, step=args.steps)
        print(f"saved {args.ckpt}", flush=True)
    return {"params": params, "opt": opt, "history": history}


if __name__ == "__main__":
    main()
