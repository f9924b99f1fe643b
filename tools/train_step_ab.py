#!/usr/bin/env python3
"""Time one LM train step with the layer groups taken as ``unbind`` views
(``repro_torch.models.lm.forward``: one stack of the groups' gradients in
backward) against indexing each group's slice of every stacked leaf (each
index adds a zero-padded full-size gradient in backward), in the order
unbind, indexed, indexed, unbind, three steps each after an untimed one;
then profile one step
with ``torch.profiler`` (device busy share, time by kernel class).

    PYTHONPATH=src python3 tools/train_step_ab.py                       # cuda, stablelm_1_6b, 4 x 512
    PYTHONPATH=src python3 tools/train_step_ab.py --device cpu --reduced --seq 32

Parameters from ``torch.Generator(device).manual_seed(3)``, batches from
``TokenPipeline(seed=3)``, remat as the config has it (``--reduced``: on).
On a CUDA device it prints the card's name and power limit; the profile is
taken there only. ``--out PATH`` writes the numbers as JSON.
"""
import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def indexed_forward(cfg, params, batch):
    """``forward`` with each group's leaves indexed out of the stack."""
    import torch

    import repro_torch.models.lm as lm

    x, positions = lm._embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(cfg.n_groups):
        gp = lm._group(params["layers"], g)
        if cfg.remat:
            x, aux = lm.checkpoint(lm._group_body, cfg, gp, x, aux, positions, use_reentrant=False)
        else:
            x, aux = lm._group_body(cfg, gp, x, aux, positions)
    return lm._head(cfg, params, x), aux


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="stablelm_1_6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    import repro_torch.models.lm as lm
    from repro_torch.config import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step

    dev = resolve_device(args.device)
    card = cs.nvidia_smi_line() if dev.type == "cuda" else "cpu"
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16", remat=True)
    params = init_params(cfg, torch.Generator(dev).manual_seed(3), dev)
    state = adamw_init(params)
    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch, seed=3, d_model=cfg.d_model,
                         mode=cfg.input_mode, n_prefix=cfg.n_prefix)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(0).items()}
    step = make_train_step(cfg, AdamWConfig(lr=1e-4, warmup_steps=0, total_steps=100))
    print(f"{cfg.name}, {args.batch} x {args.seq} tokens, remat {cfg.remat} on {dev} [{card}]")

    unbind_forward = lm.forward
    step(params, state, batch)  # warm-up, untimed (its outputs dropped)
    runs = {"unbind": [], "indexed": []}
    try:
        for name in ("unbind", "indexed", "indexed", "unbind"):
            lm.forward = unbind_forward if name == "unbind" else indexed_forward
            for _ in range(3):
                cs._reset_peak(dev)
                out, sec = cs._synced(dev, lambda: step(params, state, batch))
                runs[name].append({"seconds": sec, "peak_gib": cs._peak_gib(dev), "loss": float(out[2]["loss"])})
                del out
            print(f"  {name:8s} {[round(r['seconds'], 4) for r in runs[name][-3:]]} s, peak "
                  f"{runs[name][-1]['peak_gib']:.2f} GiB, loss {runs[name][-1]['loss']:.6f}", flush=True)
    finally:
        lm.forward = unbind_forward
    losses = {r["loss"] for rs in runs.values() for r in rs}
    if len(losses) != 1:
        print(f"the two groupings disagree: losses {sorted(losses)}", file=sys.stderr)
        return 1
    profile = None
    if dev.type == "cuda":
        profile = cs._profile_window(f"one {cfg.name} train step, {args.batch} x {args.seq}",
                                     lambda: step(params, state, batch))
    if args.out:
        out_path = Path(args.out)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps({"card": card, "runs": runs, "profile": profile}, indent=1))
    print(f"done [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
