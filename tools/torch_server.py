#!/usr/bin/env python
"""Standalone log collector / restart broadcaster on the PyTorch port
(the twin of tools/server.py; reference: tools/server/server.c — a
clap-core build without graphics). Imports only clap_tpu_torch, so it
runs where JAX is not installed.

Usage: python tools/torch_server.py [--port 21044]
Commands on stdin: 'restart' broadcasts a restart to all clients.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from clap_tpu_torch.utils.telemetry import DEFAULT_PORT, TelemetryServer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=DEFAULT_PORT)
    args = ap.parse_args()

    def on_message(msg, addr):
        t = msg.get("type")
        if t == "log":
            print(f"[{msg.get('level','?'):5}] {msg.get('msg','')}")
        elif t == "status":
            print("status:", {k: v for k, v in msg.items()
                              if k not in ("type", "ts")})

    srv = TelemetryServer(port=args.port, on_message=on_message)
    print(f"clap-tpu telemetry server on :{srv.port} (type 'restart' + enter)")
    try:
        for line in sys.stdin:
            if line.strip() == "restart":
                srv.broadcast_restart()
                print("broadcast restart")
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()


if __name__ == "__main__":
    main()
