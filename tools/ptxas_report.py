"""Registers, spills and shared memory of the port's kernels, as ptxas
reports them (on a machine with nvcc).

    python3 tools/ptxas_report.py flash_fwd.cu paged_attention.cu [--match RE]

Compiles each named ``flashattn_tpu_torch/csrc`` source (or a path to
another ``.cu`` that includes csrc's headers) with the library's
flags plus ``-Xptxas -v`` (one nvcc each, in parallel) and prints a line a
kernel instance: its name with its mangled template arguments
(``flash_fwd_tc_kernelILi256ELb0EE``), registers, spill stores and loads,
and static shared memory.  ``--match`` keeps the instances whose
mangled name matches the regular expression (``256`` for the 256-column
tiles' instances).
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def short(name: str) -> str:
    """A mangled kernel name's identifier (the length-prefixed one ending in
    "kernel") and its template arguments, still mangled."""
    end = name.find("kernel") + len("kernel")
    if end < len("kernel"):
        return name
    for start in range(end - 1, 0, -1):
        n = str(end - start)
        if name[max(0, start - len(n)):start] == n:
            args = re.match(r"I\w*?EE", name[end:])
            return name[start:end] + (args.group(0) if args else "")
    return name


def report(sources, match: str | None) -> int:
    from flashattn_tpu_torch.ops import _build

    csrc = REPO / "flashattn_tpu_torch" / "csrc"
    procs = [(src, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(csrc),
         "-c", str(csrc / src if (csrc / src).exists() else Path(src)), "-o",
         "/dev/null"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in sources]
    failed = 0
    for src, proc in procs:
        out, _ = proc.communicate()
        name, keep = "", False
        for line in out.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                keep = match is None or re.search(match, name) is not None
            elif keep and ("registers" in line or "spill" in line):
                print(f"[ptxas] {src} {short(name)[:80]}: "
                      f"{line.split(':', 1)[-1].strip()}", flush=True)
        if proc.returncode:
            print(out[-6000:], flush=True)
            failed += 1
    return failed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+", help="files under csrc/")
    ap.add_argument("--match", default=None,
                    help="keep kernel instances whose mangled name matches")
    args = ap.parse_args()
    return 1 if report(args.sources, args.match) else 0


if __name__ == "__main__":
    sys.exit(main())
