#!/usr/bin/env python3
"""Time one networked submit through a loopback mesh whose three party
threads take turns (``launch_loopback_mesh``, the runtime's default)
against one whose party threads contend for the interpreter lock (the same
servers with no ``turn`` lock), in the order on, off, off, on, after two
in-process submits of the same query (the second is the warm one).

    PYTHONPATH=src python3 tools/turn_lock_ab.py                      # cuda, n=8192
    PYTHONPATH=src python3 tools/turn_lock_ab.py --device cpu --n 16

Uses ``chip_smoke.py``'s data: ``generate_healthlnk(n, seed=0)``, a catalog
declaring each table's pid bound, the service's defaults, key seed 42. On a
CUDA device it builds the kernels first and prints the card's name and
power limit.
"""
import argparse
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def contended_mesh(device):
    """Three party threads over a loopback mesh, no turn lock."""
    from repro_torch.runtime.coordinator import Coordinator
    from repro_torch.runtime.party import PartyServer
    from repro_torch.runtime.transport import COORD, LoopbackMesh, LoopbackTransport

    mesh = LoopbackMesh()
    servers = []
    for p in range(3):
        tr = LoopbackTransport(mesh, p)
        servers.append(PartyServer(p, tr, tr, device=device))
    threads = [threading.Thread(target=s.serve, daemon=True) for s in servers]
    for t in threads:
        t.start()
    coord = Coordinator(LoopbackTransport(mesh, COORD))
    coord.party_threads = threads
    coord.hello()
    return coord


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--query", default="dosage_study")
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.config import resolve_device
    from repro_torch.core import threefry
    from repro_torch.data import QUERY_SQL, generate_healthlnk
    from repro_torch.runtime import ReflexClient, launch_loopback_mesh
    from repro_torch.sql import Catalog

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        import repro_torch.kernels as kernels

        kernels.build()
        kernels.library()
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    else:
        card = "cpu"

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    tables, plain = generate_healthlnk(n=args.n, seed=0, device=dev)
    mult = {t: {"pid": int(np.bincount(cols["pid"]).max())} for t, cols in plain.items()}
    catalog = Catalog.from_tables(tables, multiplicity=mult)
    sql = QUERY_SQL[args.query]

    def timed(client):
        sync()
        t0 = time.perf_counter()
        client.submit("a", sql)
        sync()
        return time.perf_counter() - t0

    local = ReflexClient.in_process(tables, catalog=catalog, key=threefry.PRNGKey(42), offline="off", device=dev)
    for i in range(2):
        print(f"in-process {i}: {timed(local):.3f} s", flush=True)
    local.close()
    for mode in ("on", "off", "off", "on"):
        coord = launch_loopback_mesh(device=dev)[0] if mode == "on" else contended_mesh(dev)
        client = ReflexClient.networked(tables, coordinator=coord, catalog=catalog, key_seed=42, device=dev)
        dt = timed(client)
        audit = client.service.engine.last_wire_audit
        print(f"turn {mode}: {dt:.3f} s; stall {[a['stall_seconds'] for a in audit]}; bodies "
              f"{[a['body_seconds'] for a in audit]}", flush=True)
        client.close()
    print(f"{args.query} n={args.n} on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
