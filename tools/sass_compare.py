"""Compare the machine code (SASS) of one kernel source in two checkouts.

    python3 tools/sass_compare.py ROOT_A ROOT_B flash_fwd.cu [PATTERN]

Compiles ``ROOT/flashattn_tpu_torch/csrc/<file>`` of each root with nvcc
(sm_90a, the package's flags) and ``cuobjdump -sass``, then, for every
kernel whose demangled name matches PATTERN (a regex, default: all), prints
whether its instructions are the same in both (addresses, comments and
the offsets of kernel parameters stripped; a kernel of A whose last template argument, false, went away in
B is matched by the name without it).  Needs the CUDA toolkit: run it on
the card's machine.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from flashattn_tpu_torch.ops import _build  # noqa: E402


def sass(root: str, src: str) -> dict:
    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        obj = Path(tmp) / "k.o"
        csrc = Path(root) / "flashattn_tpu_torch" / "csrc"
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", str(csrc), "-c", str(csrc / src),
                        "-o", str(obj)], check=True, capture_output=True)
        dump = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(obj)],
                              check=True, capture_output=True, text=True).stdout
        names = subprocess.run([str(Path(nvcc).parent / "cu++filt")], input=dump,
                               capture_output=True, text=True).stdout or dump
    out, name = {}, None
    for line in names.splitlines():
        m = re.match(r"\s*Function : (.*)", line)
        if m:
            name = m.group(1).strip()
            out[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            # kernel parameters are read from constant bank 0 at offsets that
            # move when a parameter is added or removed
            out[name].append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][param]",
                                    re.sub(r"/\*.*?\*/|;", "", line)).strip())
    return out


def key(name: str) -> str:
    """The kernel's demangled name without its parameters."""
    name = re.sub(r"\(bool\)0", "false", re.sub(r"\(bool\)1", "true", name))
    name = re.sub(r"\((unsigned int|int)\)", "", name)
    name = name.replace("(anonymous namespace)", "<unnamed>")
    return name.split("(")[0]


def main() -> int:
    root_a, root_b, src = sys.argv[1:4]
    pattern = re.compile(sys.argv[4] if len(sys.argv) > 4 else ".")
    a, b = sass(root_a, src), sass(root_b, src)
    b_by_key = {key(n): body for n, body in b.items()}
    same = True
    for name, body in sorted(a.items()):
        if not pattern.search(name):
            continue
        other = b_by_key.get(key(name), b_by_key.get(re.sub(r", false>", ">", key(name))))
        verdict = ("missing in B" if other is None else
                   "same SASS" if other == body else
                   f"differs ({len(body)} vs {len(other)} instructions)")
        same &= verdict == "same SASS"
        print(f"[sass] {key(name)}: {verdict}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
