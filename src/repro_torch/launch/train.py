"""End-to-end training launcher (example application + fault-tolerance demo).

A port of ``repro.launch.train``, with its flags and printed lines. Trains
any registered architecture on the synthetic resumable pipeline:

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b --reduced \\
      --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt

* runs on ``--device`` (default ``cuda``; raises without a card, so pass
  ``--device cpu`` for the plain CPU run);
* checkpoints (atomic, async, keep-k) every ``--ckpt-every`` steps;
* auto-resumes from the latest checkpoint in ``--ckpt-dir``
  (bitwise-identical continuation: the pipeline is a pure function of
  (seed, step));
* ``--simulate-failure N`` stops at step N and returns 17, to exercise the
  restart path.

Parameters come from ``torch.Generator(device).manual_seed(seed)``.
``main(argv)`` returns the exit code, so callers can run it in-process.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from ..config import resolve_device
from ..configs import get_config
from ..data.pipeline import TokenPipeline
from ..models import init_params
from ..train import AdamWConfig, Checkpointer, adamw_init, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-async", action="store_true")
    ap.add_argument("--simulate-failure", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    # keep the smoke seq length inside the windowed archs' horizon
    cfg = dataclasses.replace(cfg, remat=False)

    pipe = TokenPipeline(
        vocab_size=cfg.vocab_size,
        seq_len=args.seq,
        global_batch=args.batch,
        seed=args.seed,
        d_model=cfg.d_model,
        mode=cfg.input_mode,
        n_prefix=cfg.n_prefix,
    )
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, args.grad_accum)

    params = init_params(cfg, torch.Generator(device).manual_seed(args.seed), device)
    opt_state = adamw_init(params)
    start_step = 0

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt is not None and ckpt.latest_step() is not None:
        start_step, state = ckpt.restore(None, {"params": params, "opt": opt_state, "meta": {}})
        params, opt_state = state["params"], state["opt"]
        print(f"[resume] restored step {start_step} from {args.ckpt_dir}")

    t0 = time.time()
    losses = []
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch_at(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(
                f"step {step:5d} loss {float(metrics['loss']):.4f} "
                f"lr {float(metrics['lr']):.2e} gn {float(metrics['grad_norm']):.2f} "
                f"({(time.time()-t0):.1f}s)",
                flush=True,
            )
        next_step = step + 1
        if ckpt is not None and (next_step % args.ckpt_every == 0 or next_step == args.steps):
            state = {"params": params, "opt": opt_state, "meta": {"arch": args.arch}}
            if args.ckpt_async:
                ckpt.save_async(next_step, state)
            else:
                ckpt.save(next_step, state)
        if args.simulate_failure is not None and next_step >= args.simulate_failure:
            print(f"[failure-sim] aborting at step {next_step}", flush=True)
            if ckpt is not None:
                ckpt.wait()
            return 17
    if ckpt is not None:
        ckpt.wait()
    print(
        f"final: loss[first 5]={np.mean(losses[:5]):.4f} "
        f"loss[last 5]={np.mean(losses[-5:]):.4f} steps={args.steps}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
