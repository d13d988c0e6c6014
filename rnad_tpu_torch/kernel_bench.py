"""What ptxas and the SASS say of the committed K1 and K3.

    python3 -m rnad_tpu_torch.kernel_bench

Builds ``csrc/fused_turn.cu`` and ``csrc/rmplus.cu`` (``ops/_build.py``),
prints what ptxas reports for each kernel (registers, spills) and counts
the SASS instructions of every loop of the kernels at the paths' sizes,
``fused_turn_kernel<3>`` (the float32 variant),
``fused_turn_bf16_kernel<3>`` (the bf16-operand variant) and
``rmplus_kernel<5>`` (``cuobjdump -sass``), with their FFMA and their
tensor-core instructions (HMMA for ``mma.sync``, HGMMA for ``wgmma``).
K3 has two iteration loops, one for games whose masks hold only 0 and 1
and one for any other mask; the float32 K1's k loop is the one with the
most FFMA, the bf16 K1's pass loop the one with the HMMA.  Needs the CUDA
toolkit; the kernels' times are ``chip_smoke.py``'s.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

from .ops import _build

KERNELS = (("fused_turn", "fused_turn_kernelILi3EE", "fused_turn_kernel<3>"),
           ("fused_turn", "fused_turn_bf16_kernelILi3EE",
            "fused_turn_bf16_kernel<3>"),
           ("rmplus", "rmplus_kernelILi5E", "rmplus_kernel<5>"))


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    return found or str(Path(_build._nvcc()).parent / "cuobjdump")


def sass_loops(lib_path: Path, mangled_part: str):
    """Loops of the one function whose mangled name holds ``mangled_part``:
    a sorted list of (instructions, FFMA, HMMA + HGMMA), one per backward
    branch."""
    text = subprocess.run([_cuobjdump(), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    body, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = mangled_part in line
            continue
        if inside:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m:
                body.append((int(m.group(1), 16), m.group(2)))
    opcode = lambda ins: ins.split()[1 if ins.startswith("@") else 0]
    loops = []
    for addr, ins in body:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            start = int(m.group(1), 16)
            ops = [opcode(i) for a, i in body if start <= a <= addr]
            ops = [o for o in ops if o != "NOP"]
            base = [o.split(".")[0] for o in ops]
            loops.append((len(ops), base.count("FFMA"),
                          base.count("HMMA") + base.count("HGMMA")))
    return sorted(set(loops))


def main() -> None:
    _build.build(sorted({name for name, _, _ in KERNELS}))
    for name, part, kernel in KERNELS:
        path = _build.library_path(name)
        regs = [r for k, r in _build.ptxas_lines(_build.build_log(name))
                if k == kernel]
        print(f"{kernel}: ptxas {regs}; SASS loops (instructions, FFMA, "
              f"HMMA + HGMMA) {sass_loops(path, part)}", flush=True)


if __name__ == "__main__":
    main()
