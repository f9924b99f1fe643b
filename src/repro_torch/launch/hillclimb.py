"""Perf hillclimb harness: hypothesis -> change -> re-count -> validate.

A port of ``repro.launch.hillclimb``: the same named variants (``VARIANTS``,
the reference's, verbatim), each an ``ArchConfig`` override run through the
port's dry-run (``launch/dryrun.py``: the sharded step on ``meta`` tensors
over a fake process group, counted), writing
``artifacts/perf_torch_<arch>_<shape>.json`` for ``ROOFLINE_TORCH.md``'s
perf log. The terms are bounds from the H100's data-sheet constants, not
measurements.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch mixtral_8x7b \
      --shape train_4k --variants baseline,remat_off,cap_full,cap_reflex_tlap
"""
import argparse
import json
import os
import time

VARIANTS = {
    # name -> (overrides dict, hypothesis string)
    "baseline": ({}, "paper-faithful baseline (remat on, const capacity 1.25)"),
    "remat_off": (
        {"remat": False},
        "remat recomputes the fwd pass: dropping it cuts HLO FLOPs ~25% "
        "(t_compute) at the cost of activation memory",
    ),
    "cap_full": (
        {"capacity_policy": "full"},
        "fully-'oblivious' MoE capacity (C=tokens): upper-bounds the EP "
        "dispatch volume — expect collective/memory terms to balloon ~E/topk x",
    ),
    "cap_const_1_0": (
        {"capacity_factor": 1.0},
        "trim capacity to the balanced load exactly (eta=0, 'revealed' "
        "analogue): dispatch volume down 20% vs cf=1.25",
    ),
    "cap_reflex_tlap": (
        {"capacity_policy": "reflex_tlap"},
        "Reflex TLap slack: near-balanced capacity + DP-style headroom — "
        "dispatch volume within a few % of cf=1.0 with drop protection",
    ),
    "cap_reflex_beta": (
        {"capacity_policy": "reflex_beta"},
        "Reflex Beta(2,6) slack (25% of free space): between const and full",
    ),
    "ce_einsum": (
        {"ce_impl": "einsum"},
        "cross-entropy via one-hot einsum keeps vocab-sharded logits local "
        "(reduce over vocab shards) instead of all-gathering (B,S,V) logits",
    ),
    "no_zero1": (
        {"zero1": False},
        "ZeRO-1 moment sharding off: fewer spec constraints, more HBM/device",
    ),
    "moe_gather": (
        {"moe_impl": "gather"},
        "one-hot dispatch matmuls cost 2*T*E*C*D flops (>> expert FFNs); "
        "gather/scatter dispatch keeps only FFN flops — expect t_compute to "
        "collapse to ~active-param matmuls",
    ),
    "moe_gather_reflex": (
        {"moe_impl": "gather", "capacity_policy": "reflex_tlap"},
        "gather dispatch + Reflex TLap capacity: compound the flop fix with "
        "a ~20% dispatch-buffer trim (collective + memory terms)",
    ),
    "mla_rank_shard": (
        {"mla_shard": "rank"},
        "MLA up-projections sharded on latent rank (contraction) instead of "
        "per-head features: one psum per projection replaces the per-head "
        "feature reshards that SPMD resolves by full rematerialization",
    ),
    "constrain_acts": (
        {"constrain_acts": True},
        "pin the residual stream to (dp, None, None): stops attention-internal "
        "shardings from leaking and forcing involuntary full replication",
    ),
    "acts_and_rank": (
        {"constrain_acts": True, "mla_shard": "rank"},
        "combine the two sharding fixes",
    ),
    "acts_and_gather": (
        {"constrain_acts": True, "moe_impl": "gather"},
        "combine residual pinning with gather dispatch",
    ),
    "gather_ce_einsum": (
        {"moe_impl": "gather", "ce_impl": "einsum"},
        "after the dispatch fix the cell is collective-bound: the vocab-"
        "sharded logits gather in CE is the next suspect — einsum CE keeps "
        "the (B,S,V) logits local",
    ),
    "gather_no_remat": (
        {"moe_impl": "gather", "remat": False},
        "with dispatch fixed, remat's fwd recompute is a real fraction of "
        "t_compute/t_memory again",
    ),
    "rank_no_remat": (
        {"mla_shard": "rank", "remat": False},
        "memory-bound after the collective fix: drop remat's recompute reads",
    ),
    "rank_ce_einsum": (
        {"mla_shard": "rank", "ce_impl": "einsum"},
        "prefill logits over 73k vocab: einsum CE avoids gathering them",
    ),
    "decode_bf16_scores": (
        {"decode_score_dtype": "bf16"},
        "decode is memory-bound on the (B,H,32k) f32 score intermediates: "
        "bf16 scores + additive mask halve the dominant traffic",
    ),
    "rank_chunked": (
        {"mla_shard": "rank", "attn_impl": "chunked"},
        "dense 32k x 32k scores need ~700 GB/device of temps (memory_analysis "
        "— does NOT fit HBM): flash-style online-softmax chunking keeps only "
        "(S, chunk) tiles live; MLA K/V built per-chunk from the latent",
    ),
    "chunked_only": (
        {"attn_impl": "chunked"},
        "chunked attention alone (without the MLA rank-sharding fix)",
    ),
    "gather_chunked": (
        {"moe_impl": "gather", "attn_impl": "chunked", "remat": False},
        "compose all confirmed wins for the MoE train cell",
    ),
    "sp_only": (
        {"attn_sp": True},
        "40 heads % 16 != 0 leaves (B,H,S,S) scores REPLICATED (651 GiB/dev "
        "temps): shard query rows over 'model' (S always divides) — expect "
        "temp ~ /16",
    ),
    "sp_chunked_rank": (
        {"attn_sp": True, "attn_impl": "chunked", "mla_shard": "rank"},
        "compose: SP query sharding + flash-chunked tiles + latent-rank TP — "
        "target: fits 16 GB HBM",
    ),
    "sp_chunked": (
        {"attn_sp": True, "attn_impl": "chunked"},
        "SP + chunked without the MLA rank fix (ablation)",
    ),
    "kv_int8": (
        {"kv_quant": True},
        "decode reads the whole KV cache per token: int8 cache (+per-pos/head "
        "bf16 scales) halves that dominant traffic; logit err < 0.03, argmax "
        "agreement 100% in tests",
    ),
    "kv_int8_bf16": (
        {"kv_quant": True, "decode_score_dtype": "bf16"},
        "compose int8 cache with bf16 score tensors",
    ),
}


def main(argv=None) -> None:
    from .dryrun import run_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--out-dir", default="artifacts")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    out_path = os.path.join(args.out_dir, f"perf_torch_{args.arch}_{args.shape}.json")
    results = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)

    for name in args.variants.split(","):
        if any(r["variant"] == name for r in results):
            continue
        overrides, hypothesis = VARIANTS[name]
        t0 = time.time()
        row = run_cell(args.arch, args.shape, args.multi_pod, opt_overrides=overrides or None)
        row["variant"] = name
        row["hypothesis"] = hypothesis
        row["wall_s"] = time.time() - t0
        results.append(row)
        if row["status"] == "ok":
            print(
                f"[{name:>16}] tc={row['t_compute_s']:.3e} tm={row['t_memory_s']:.3e} "
                f"tx={row['t_collective_s']:.3e} bottleneck={row['bottleneck']} "
                f"frac={row['roofline_fraction']:.4f} args={row['bytes_per_device'] / 2**30:.1f}GiB/device",
                flush=True,
            )
        else:
            print(f"[{name:>16}] {row['status']}: {row.get('error', '')[:200]}", flush=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
