"""One rank of the sharded-training rehearsal (``tests/test_torch_sharding_gloo.py``).

Run as four processes on the CPU: ``python tests/torch_sharding_worker.py
RANK WORLD STORE_PATH OUT_DIR``. They join a ``gloo`` process group through
a ``FileStore`` and build a (2, 2) ("data", "model") mesh and a (2, 1, 2)
("pod", "data", "model") mesh, the multi-pod mesh's shape. For each reduced
architecture, every rank computes the unsharded loss, gradients and AdamW
step and the sharded ones on (2, 2) (parameters by ``make_param_specs``,
the moments by ``zero1_specs``, the batch by ``batch_specs``), and the
sharded loss and gradients on (2, 1, 2), gathers the sharded trees and
writes the scaled errors to ``OUT_DIR/rank<r>.json``; the checkpoint drill
restores an unsharded checkpoint into the (2, 2) mesh and back.
Imports only torch and the port.
"""
import dataclasses
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist

ARCHS = ("stablelm_1_6b", "mixtral_8x7b", "minicpm3_4b", "recurrentgemma_9b", "xlstm_1_3b")
CONSTRAINED = ("stablelm_1_6b", "minicpm3_4b")  # attention and MLA: attn_sp's two sites
CONTRACTION = ("stablelm_1_6b", "xlstm_1_3b")  # attention and mLSTM cores with one head
SEED = 22
BATCH, SEQ = 4, 16


def scaled_err(want: dict, got: dict) -> float:
    """max over leaves of max|got - want| / max(1, max|want|)."""
    from repro_torch.models.lm import tree_items

    worst = 0.0
    for (pa, w), (pb, g) in zip(tree_items(want), tree_items(got)):
        assert pa == pb and w.shape == g.shape and w.dtype == g.dtype, (pa, pb)
        w, g = w.double(), g.double()
        assert bool(torch.isfinite(g).all()), pb
        if w.numel():
            worst = max(worst, float((g - w).abs().max()) / max(1.0, float(w.abs().max())))
    return worst


def scalar_err(a, b) -> float:
    return abs(float(a) - float(b)) / max(1.0, abs(float(a)))


def layouts(tree: dict) -> dict:
    from repro_torch.models.lm import tree_items

    return {path: [repr(p) for p in t.placements] for path, t in tree_items(tree)}


def pod_case(cfg, params, batch, want: tuple, mesh) -> dict:
    """The sharded loss and gradients on the multi-pod mesh's shape against
    the unsharded ``want`` (loss, metrics, gradients)."""
    from repro_torch.sharding import batch_specs, distribute_tree, gather_tree
    from repro_torch.train import adamw_init, place_train_state
    from repro_torch.train.train_step import loss_and_grads

    loss, metrics, grads = want
    p_sh, _ = place_train_state(cfg, params, adamw_init(params), mesh)
    b_sh = distribute_tree(batch, batch_specs(cfg, batch, mesh), mesh)
    loss_sh, metrics_sh, grads_sh = loss_and_grads(cfg, p_sh, b_sh)
    return {
        "loss": scalar_err(loss, loss_sh),
        "ce": scalar_err(metrics["ce"], metrics_sh["ce"]),
        "grads": scaled_err(grads, gather_tree(grads_sh)),
        "grad_layout_ok": layouts(grads_sh) == layouts(p_sh),
        "model_sharded": any(p[-1].startswith("Shard") for p in layouts(p_sh).values()),
    }


def arch_case(arch: str, mesh, pod_mesh) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import init_params
    from repro_torch.sharding import batch_specs, distribute_tree, gather_tree
    from repro_torch.train import AdamWConfig, adamw_init, adamw_update, place_train_state
    from repro_torch.train.train_step import loss_and_grads

    mla = "rank" if arch == "minicpm3_4b" else "feature"
    cfg = dataclasses.replace(get_config(arch).reduced(), mla_shard=mla)
    params = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    pipe = TokenPipeline(cfg.vocab_size, SEQ, BATCH, seed=SEED, d_model=cfg.d_model, mode=cfg.input_mode,
                         n_prefix=cfg.n_prefix)
    batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(0).items()}
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)

    # the train step's two halves (make_train_step without accumulation)
    loss, metrics, grads = loss_and_grads(cfg, params, batch)
    new_p, new_s, new_m = adamw_update(opt, grads, params, adamw_init(params))

    p_sh, s_sh = place_train_state(cfg, params, adamw_init(params), mesh)
    b_sh = distribute_tree(batch, batch_specs(cfg, batch, mesh), mesh)
    loss_sh, metrics_sh, grads_sh = loss_and_grads(cfg, p_sh, b_sh)
    grad_layout_ok = layouts(grads_sh) == layouts(p_sh)
    newp_sh, news_sh, newm_sh = adamw_update(opt, grads_sh, p_sh, s_sh)
    out = {
        "loss": scalar_err(loss, loss_sh),
        "ce": scalar_err(metrics["ce"], metrics_sh["ce"]),
        "grads": scaled_err(grads, gather_tree(grads_sh)),
        "grad_norm": scalar_err(new_m["grad_norm"], newm_sh["grad_norm"]),
        "params": scaled_err(new_p, gather_tree(newp_sh)),
        "moments": scaled_err({"m": new_s["m"], "v": new_s["v"]},
                              gather_tree({"m": news_sh["m"], "v": news_sh["v"]})),
        "count": int(news_sh["count"]) == int(new_s["count"]) == 1,
        "grad_layout_ok": grad_layout_ok,
        "param_layout_kept": layouts(newp_sh) == layouts(p_sh),
        "moment_layout_kept": layouts(news_sh["m"]) == layouts(s_sh["m"]),
        # ZeRO-1: some moment is sharded over "data" where its parameter is not
        "zero1_sharded": any(pm[0] == "Replicate()" and mm[0].startswith("Shard")
                             for pm, mm in zip(layouts(p_sh).values(), layouts(s_sh["m"]).values())),
        "model_sharded": any(p[1].startswith("Shard") for p in layouts(p_sh).values()),
    }
    out["pod"] = pod_case(cfg, params, batch, (loss, metrics, grads), pod_mesh)
    if arch in CONSTRAINED:  # the activation constraints on give the result they give off
        on = dataclasses.replace(cfg, constrain_acts=True, attn_sp=True)
        loss_on, _, grads_on = loss_and_grads(on, p_sh, b_sh)
        out["constrained_loss"] = scalar_err(loss_sh, loss_on)
        out["constrained_grads"] = scaled_err(gather_tree(grads_sh), gather_tree(grads_on))
    return out


def contraction_case(arch: str, pod_mesh) -> dict:
    """One head on (2, 1, 2): the heads cannot split over "model", so the
    attention and mLSTM cores split their q.k contraction there and sum the
    scores (all-reduces forward and back)."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import init_params
    from repro_torch.train.train_step import loss_and_grads

    one = {"n_heads": 1, "n_kv_heads": 1, "head_dim": 64}
    cfg = dataclasses.replace(get_config(arch).reduced(), **one)
    params = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    pipe = TokenPipeline(cfg.vocab_size, SEQ, BATCH, seed=SEED, d_model=cfg.d_model, mode=cfg.input_mode,
                         n_prefix=cfg.n_prefix)
    batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(0).items()}
    return pod_case(cfg, params, batch, loss_and_grads(cfg, params, batch), pod_mesh)


def checkpoint_case(mesh, rank: int) -> dict:
    """An unsharded checkpoint restored into the (2, 2) layout, then saved
    from it and restored unsharded: every leaf equal, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import abstract_params, init_params
    from repro_torch.models.lm import tree_items, tree_map
    from repro_torch.sharding import P, gather_tree, make_param_specs, named, zero1_specs
    from repro_torch.train import Checkpointer, adamw_init

    cfg = get_config("stablelm_1_6b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    state = {"m": tree_map(lambda t: 0.5 * t, params), "v": tree_map(torch.square, params),
             "count": torch.tensor(3, dtype=torch.int32)}
    tree = {"params": params, "opt": state, "meta": {"step": 3}}
    p_specs = make_param_specs(cfg, params, mesh)
    m_specs = zero1_specs(p_specs, params, mesh)
    specs = {"params": p_specs, "opt": {"m": m_specs, "v": m_specs, "count": P()}}
    with tempfile.TemporaryDirectory() as tmp:
        Checkpointer(os.path.join(tmp, "whole")).save(3, tree)
        like = {"params": abstract_params(cfg), "opt": adamw_init(abstract_params(cfg))}
        step, restored = Checkpointer(os.path.join(tmp, "whole")).restore(None, like, shardings=named(mesh, specs))
        placed = all(hasattr(t, "placements") for _, t in tree_items({k: restored[k] for k in ("params", "opt")}))
        sharded = any(any(repr(p).startswith("Shard") for p in t.placements)
                      for _, t in tree_items(restored["params"]))
        back = gather_tree({k: restored[k] for k in ("params", "opt")})
        into = all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items({k: tree[k] for k in ("params", "opt")}),
                                                                 tree_items(back)))
        # and back: every rank gathers; each writes its own directory
        Checkpointer(os.path.join(tmp, f"from_mesh_{rank}")).save(4, restored)
        _, again = Checkpointer(os.path.join(tmp, f"from_mesh_{rank}")).restore(None, like, device="cpu")
        out_again = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_items({k: tree[k] for k in ("params", "opt")}), tree_items({k: again[k] for k in ("params", "opt")})))
    return {"step": step, "meta": restored["meta"], "placed": placed, "sharded": sharded, "into_mesh_equal": into,
            "back_equal": out_again}


def main(rank: int, world: int, store_path: str, out_dir: str) -> None:
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        pod_mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), "cpu")
        result = {arch: arch_case(arch, mesh, pod_mesh) for arch in ARCHS}
        result["contraction"] = {arch: contraction_case(arch, pod_mesh) for arch in CONTRACTION}
        result["checkpoint"] = checkpoint_case(mesh, rank)
        result["mesh"] = [list(mesh.mesh_dim_names), list(mesh.shape)]
        result["pod_mesh"] = [list(pod_mesh.mesh_dim_names), list(pod_mesh.shape)]
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
