"""Count the machine (SASS) instructions of each kernel in a built CUDA
library of tendermintx_tpu_torch: in all and by opcode class, and for each
loop (a backward branch) those of its body.

    python3 tools/sass_census.py [name ...]    # default: poseidon

Builds csrc/<name>.cu if needed (ops/cuda_build.py, needs nvcc),
disassembles the library with the toolkit's cuobjdump and prints one JSON
object {name: {kernel: census}}. A one-off reading aid for kernel work: the
package and chip_smoke.py do not use it.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _count(ops: list[str]) -> dict[str, int]:
    counts: dict[str, int] = {}
    for op in ops:
        k = "IMAD.WIDE" if op.startswith("IMAD.WIDE") else op.split(".")[0]
        counts[k] = counts.get(k, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def parse_sass(text: str) -> dict[str, dict]:
    """{kernel: {"instructions", "by_opcode", "loops"}} from cuobjdump -sass
    output. Each loop is a backward branch: the body's first and last
    address, its instruction count and its counts by opcode class."""
    kernels: dict[str, list] = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = kernels.setdefault(m.group(1), [])
            continue
        m = _SASS_LINE.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for kernel, ins in kernels.items():
        loops = []
        for addr, op, args in ins:
            t = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
            if t and int(t.group(1), 16) < addr:
                start = int(t.group(1), 16)
                body = [o for a, o, _ in ins if start <= a <= addr]
                loops.append({"start": start, "end": addr, "instructions": len(body), "by_opcode": _count(body)})
        out[kernel] = {"instructions": len(ins), "by_opcode": _count([o for _, o, _ in ins]), "loops": loops}
    return out


def main(names: list[str]) -> int:
    from tendermintx_tpu_torch.ops import cuda_build

    cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    out = {}
    for name in names or ["poseidon"]:
        proc = subprocess.run([cuobjdump, "-sass", cuda_build.build(name)], capture_output=True, text=True, check=True)
        out[name] = parse_sass(proc.stdout)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
