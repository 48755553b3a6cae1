"""Port of api_ratelimit_tpu/cmd/config_check_cmd.py: the offline config
linter (src/config_check_cmd/main.go).

    python -m api_ratelimit_tpu_torch.cmd.config_check_cmd -config_dir ./config

Loads every YAML under -config_dir through the real loader with a null stats
store; prints the error and exits 1 on an invalid config.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..config.loader import ConfigFile, load_config
from ..models.config import ConfigError
from ..stats.store import new_null_store


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "-config_dir",
        default=os.getcwd(),
        help="path to directory containing rate limit configs",
    )
    args = parser.parse_args(argv)

    files = []
    for name in sorted(os.listdir(args.config_dir)):
        if not name.endswith((".yaml", ".yml")):
            continue
        path = os.path.join(args.config_dir, name)
        with open(path, "r", encoding="utf-8") as f:
            files.append(ConfigFile(name=name, contents=f.read()))

    try:
        load_config(files, new_null_store().scope("ratelimit"))
    except ConfigError as e:
        print(f"error loading config: {e}", file=sys.stderr)
        return 1
    print(f"config ok ({len(files)} files)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
