#!/usr/bin/env python3
"""Build a tree's csrc/megakernel.cu as a CPU library through the shim
(cuda_runtime.h beside this file), to run its kernels here with run.py.

    python3 tools/cuda_shim/build.py SRC.cu OUT.so

The source is rewritten first: the DMMA helpers (dmma, dmma16) call the
shim's emulations, any other inline PTX is dropped, the dynamic shared
memory becomes one static array (the blocks run one at a time), and every
`kernel<<<grid, block, ...>>>(args);` becomes `shim_launch(grid, block,
[&] { kernel(args); });`. g++ -O1 -ffp-contract=off (no multiply-add
contraction, as nvcc's -fmad=false)."""
from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent


def rewrite(src: str) -> str:
    s = "#include <mutex>\n" + src
    s = re.sub(r"(void dmma\(double& d0, double& d1, double a,\s*double b\) "
               r"\{).*?\n\}", r"\1 shim_dmma(d0, d1, a, b); }", s,
               flags=re.S)
    s = re.sub(r"(void dmma16\(double \(&d\)\[4\], double a0, double a1,"
               r"\s*double b\) \{).*?\n\}",
               r"\1 shim_dmma16(d, a0, a1, b); }", s, flags=re.S)
    s = re.sub(r'asm volatile\(.*?"d"\(0\.0\)\);', "(void)0;", s, flags=re.S)
    s = s.replace("extern __shared__ __align__(16) float smem[];",
                  "static float smem[16384] __attribute__((aligned(16)));")
    return re.sub(r"(\b[A-Za-z_]\w*(?:\s*<[^;{}()]*?>)?)\s*<<<\s*([^,]+?),"
                  r"\s*([^,>]+?)(?:,[^>]*)?>>>\s*\((.*?)\);",
                  r"shim_launch(\2, \3, [&] { \1(\4); });", s, flags=re.S)


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__)
        return 2
    src, out = Path(argv[0]), Path(argv[1])
    with tempfile.TemporaryDirectory() as tmp:
        cpp = Path(tmp) / "megakernel_shim.cpp"
        cpp.write_text(rewrite(src.read_text()))
        return subprocess.run(
            ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
             "-shared", "-w", f"-I{HERE}", str(cpp), "-o", str(out),
             "-lpthread"]).returncode


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
