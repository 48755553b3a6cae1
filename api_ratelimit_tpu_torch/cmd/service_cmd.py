"""Port of api_ratelimit_tpu/cmd/service_cmd.py: the server's entry point
(src/service_cmd/main.go:5-8).

    BACKEND_TYPE=cuda python -m api_ratelimit_tpu_torch.cmd.service_cmd

One process: settings from the environment (settings.py new_settings, which
refuses what this package does not serve, FRONTEND_PROCS > 1 among them),
then Runner(settings).run(), which serves gRPC (v3, v2, health), HTTP /json
and the debug port until SIGTERM/SIGINT/SIGHUP, failing health first. The
engine runs on the card: without one, BACKEND_TYPE=cuda exits non-zero with
the engine's error, and nothing serves from the CPU.
"""

from __future__ import annotations

import sys

from ..runner import Runner
from ..settings import new_settings


def main() -> int:
    Runner(new_settings()).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
