"""Launch RSS party server(s) over TCP (the port's counterpart of the
reference's ``scripts/run_parties.py``).

One process per party (the production topology)::

    python -m repro_torch.runtime.run_parties --party 0 &
    python -m repro_torch.runtime.run_parties --party 1 &
    python -m repro_torch.runtime.run_parties --party 2 &

or a compose-style launcher that starts all three and waits::

    python -m repro_torch.runtime.run_parties --party all --device cuda

Parties listen on ``base_port + party`` and build the pair mesh among
themselves (party p dials every lower-numbered party; higher-numbered
parties dial in). With ``--party all --base-port 0`` the launcher picks a
free block of three ports itself. Each party prints
``[party p] listening on HOST:PORT`` once it listens. The coordinator
(:func:`repro_torch.runtime.connect_tcp`) dials all three and ships tables,
the engine key seed, and the mesh-wide RuntimeConfig — party processes hold
no data until then. Each party's engine runs on ``--device`` (``cuda``
unless ``cpu`` is asked for).

Each server runs until the coordinator sends ``shutdown``. ``--party all``
exits 0 when all three parties did, else with the first non-zero code.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path


def serve_one(party: int, host: str, base_port: int, device: str) -> None:
    from .party import PartyServer
    from .transport import TcpTransport

    endpoints = {p: (host, base_port + p) for p in range(3)}
    tr = TcpTransport(party, endpoints)
    bound = tr.listen()
    print(f"[party {party}] listening on {bound[0]}:{bound[1]}", flush=True)
    for q in range(3):
        if q < party:
            tr.dial(q)
    for q in range(3):
        if q > party:
            tr.wait_for(q, timeout=60.0)
    print(f"[party {party}] mesh up; serving on {device}", flush=True)
    server = PartyServer(party, tr, tr, device=device)
    try:
        server.serve()
    finally:
        server.close()
    print(f"[party {party}] shut down", flush=True)


def free_base_port(host: str, attempts: int = 64) -> int:
    """A port p with p, p+1 and p+2 all free on ``host`` (held together
    while probed, then released for the parties to bind)."""
    for _ in range(attempts):
        socks = []
        try:
            first = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            socks.append(first)
            first.bind((host, 0))
            base = first.getsockname()[1]
            if base + 2 > 65535:
                continue
            for off in (1, 2):
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                socks.append(s)
                s.bind((host, base + off))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no block of three free ports on {host}")


def launch_all(host: str, base_port: int, device: str) -> int:
    """Compose-style launcher: three party processes, torn down together."""
    if base_port == 0:
        base_port = free_base_port(host)
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (src, env.get("PYTHONPATH")) if p)
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m", "repro_torch.runtime.run_parties",
                "--party", str(p), "--host", host,
                "--base-port", str(base_port), "--device", device,
            ],
            env=env,
        )
        for p in range(3)
    ]

    def tear_down(*_sig):
        for pr in procs:
            if pr.poll() is None:
                pr.terminate()

    signal.signal(signal.SIGINT, tear_down)
    signal.signal(signal.SIGTERM, tear_down)
    codes = [pr.wait() for pr in procs]
    return next((c for c in codes if c), 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--party", required=True, choices=("0", "1", "2", "all"),
                    help="party id 0..2, or 'all' to start the full mesh")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--base-port", type=int, default=9600,
                    help="party p listens on base-port + p (default 9600; "
                         "0 with --party all: a free block)")
    ap.add_argument("--device", default="cuda",
                    help="the parties' engine device (default cuda)")
    args = ap.parse_args(argv)
    if args.party == "all":
        return launch_all(args.host, args.base_port, args.device)
    serve_one(int(args.party), args.host, args.base_port, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
