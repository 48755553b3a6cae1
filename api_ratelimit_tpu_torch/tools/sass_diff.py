"""Compare kernels of two builds of the kernel library instruction by
instruction (card only: needs the CUDA toolkit's cuobjdump).

    python -m api_ratelimit_tpu_torch.tools.sass_diff OLD.so NEW.so \
        [--pair OLD_NAME=NEW_NAME ...]

Each pair names a kernel of each library by a piece of its mangled name; the
two kernels' SASS (cuobjdump -sass, the address comments stripped) must be
the same instructions. With no --pair the fixed-window way scans are
compared: an older build's `way_scan_kernel` and `way_scan_set_kernel<NW>`
against `way_scan_kernel<false>` and `way_scan_set_kernel<NW, false>`, the
instantiations that must stay the code they were. Prints one line a pair
and exits 1 if any pair differs or is missing.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys

CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"
FIXED_WAY_SCANS = [("15way_scan_kernelEP", "15way_scan_kernelILb0EE")] + [
    (f"19way_scan_set_kernelILi{nw}EE", f"19way_scan_set_kernelILi{nw}ELb0EE") for nw in (1, 2, 4, 8)
]


def functions(library: str) -> dict:
    """{mangled kernel name: [instruction, ...]} of a built library."""
    text = subprocess.run([CUOBJDUMP, "-sass", library], capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            funcs[name] = []
        elif name and "/*" in line:
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip()
            if ins:
                funcs[name].append(ins)
    return funcs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("old")
    parser.add_argument("new")
    parser.add_argument("--pair", action="append", default=[], help="OLD_NAME=NEW_NAME")
    args = parser.parse_args(argv)
    pairs = [tuple(p.split("=", 1)) for p in args.pair] or FIXED_WAY_SCANS
    old, new = functions(args.old), functions(args.new)
    ok = True
    for old_key, new_key in pairs:
        a = [v for k, v in old.items() if old_key in k]
        b = [v for k, v in new.items() if new_key in k]
        same = len(a) == 1 and len(b) == 1 and a[0] == b[0]
        ok &= same
        counts = f"{len(a[0]) if a else 0} vs {len(b[0]) if b else 0} instructions"
        print(f"{old_key} vs {new_key}: {'identical' if same else 'DIFFERENT'} ({counts})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
