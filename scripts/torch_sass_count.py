#!/usr/bin/env python3
"""Count the SASS instructions per element of the EIG scoring kernels'
inner loop, for comparing checkouts.

    python scripts/torch_sass_count.py [--root DIR ...] [--sass-dir DIR]

For each checkout (default: this one) it builds ``csrc/eig_score.cu`` with
that checkout's own build module, disassembles kernel 2 (``score_kernel``
with the refresh, the exact entropy and one replica) in its bf16 (VEC = 8)
and fp32 (VEC = 4) flavours with ``cuobjdump -sass``, and finds the loop
over a cache row's 16-byte vectors: the innermost loop without a store
that issues the most 16-byte global loads (the refreshed row's loop
stores, the C - 1 others do not). It prints one JSON line per checkout:
for each flavour the loop's instructions (NOPs left out), those on the
path that skips a block holding a call (the exact flavour's rare
double-precision branch), its 16-byte loads, the elements one trip
scores, the instructions per element, the opcodes' counts, and the
issue-rate floor at the headline (C, N, H) = (10, 50000, 1000):
instructions x C*N*H / (132 SMs x 4 schedulers x 32 lanes x the card's
largest SM clock), one warp-instruction a scheduler a cycle.

A trip loads K rows of VEC values (one 16-byte load each) and the class's
``rows[c, :]`` and ``mixture0`` vectors beside them (VEC / 4 16-byte loads
each), so it scores ``loads * VEC * K / (K + VEC / 2)`` elements; K is
the checkout's exact-entropy rows a warp (``eig::kExactRows`` in
``csrc/eig_common.cuh``; 1 where the header has none: one row a warp).
Needs the CUDA toolkit (``nvcc``, ``cuobjdump``); the card only for its
clock (``--clock-mhz`` otherwise).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

HEADLINE = (10, 50_000, 1000)   # (C, N, H)
SMS, SCHEDULERS, LANES = 132, 4, 32

# kernel 2's two exact flavours: (name, mangled-name fragment, VEC)
FLAVOURS = (("eig_refresh_score[bfloat16]",
             "score_kernelI13__nv_bfloat16Li8ELb1ELb0ELb0E", 8),
            ("eig_refresh_score", "score_kernelIfLi4ELb1ELb0ELb0E", 4))

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+((?:@!?U?P[T0-9]+\s+)?)"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")


def functions(sass: str) -> dict[str, list[tuple[int, str, str, str]]]:
    """``{mangled name: [(address, predicate, opcode, operands), ...]}``
    from ``cuobjdump -sass`` text."""
    out: dict[str, list] = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip(),
                        m.group(3), m.group(4).strip()))
    return out


def _target(operands: str) -> int | None:
    m = re.match(r"(0x[0-9a-f]+)", operands.strip())
    return int(m.group(1), 16) if m else None


def hot_loop(insns) -> dict:
    """The row loop of one kernel: see the module docstring."""
    loops = []
    for addr, _, op, ops in insns:
        t = _target(ops) if op.startswith("BRA") else None
        if t is not None and t <= addr:
            loops.append((t, addr))
    innermost = [lp for lp in loops
                 if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1]
                            for o in loops)]

    def body(lp):
        return [i for i in insns if lp[0] <= i[0] <= lp[1]]

    def n_ldg(b):
        return sum(1 for i in b if i[2].startswith("LDG") and ".128" in i[2])

    cands = [lp for lp in innermost
             if not any(i[2].startswith("STG") for i in body(lp))]
    if not cands:
        raise RuntimeError("no loop without a store")
    lp = max(cands, key=lambda lp: n_ldg(body(lp)))
    b = [i for i in body(lp) if not i[2].startswith("NOP")]
    # blocks inside the loop that a forward branch skips and that hold a
    # call: the rare branch, left out of the hot path
    cold = set()
    for addr, pred, op, ops in b:
        t = _target(ops) if op.startswith("BRA") else None
        if t is not None and addr < t <= lp[1]:
            skipped = [i for i in b if addr < i[0] < t]
            if any(i[2].startswith("CALL") for i in skipped):
                cold.update(i[0] for i in skipped)
    hot = [i for i in b if i[0] not in cold]
    return {"range": [hex(lp[0]), hex(lp[1])], "instructions": len(b),
            "hot_instructions": len(hot), "ldg128": n_ldg(b),
            "calls": sum(1 for i in b if i[2].startswith("CALL")),
            "opcodes": dict(collections.Counter(
                i[2].split(".")[0] for i in hot).most_common())}


def rows_per_warp(root: str) -> int:
    hdr = open(os.path.join(root, "coda_tpu_torch", "csrc",
                            "eig_common.cuh")).read()
    m = re.search(r"kExactRows = (\d+)", hdr)
    return int(m.group(1)) if m else 1


def cuobjdump_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "cuobjdump")):
            return os.path.join(cand, "bin", "cuobjdump")
    found = shutil.which("cuobjdump")
    if found is None:
        raise RuntimeError("cuobjdump not found (the CUDA toolkit's)")
    return found


def card_clock_mhz() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def count(root: str, clock_mhz: float | None, sass_dir: str | None) -> dict:
    """Build the checkout's scoring library, disassemble it and count."""
    root = os.path.abspath(root)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from coda_tpu_torch.ops import build; "
            "build.build_all(('eig_score',)); "
            "print(build.library_path('eig_score'))")
    lib = subprocess.run([sys.executable, "-c", code, root], check=True,
                         capture_output=True, text=True).stdout.split()[-1]
    sass = subprocess.run([cuobjdump_path(), "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    if sass_dir:
        os.makedirs(sass_dir, exist_ok=True)
        tag = os.path.basename(root.rstrip("/")) or "root"
        with open(os.path.join(sass_dir, f"eig_score-{tag}.sass"), "w") as f:
            f.write(sass)
    funcs = functions(sass)
    K = rows_per_warp(root)
    C, N, H = HEADLINE
    res = {"root": root, "rows_per_warp": K, "clock_mhz": clock_mhz,
           "flavours": {}}
    for name, frag, vec in FLAVOURS:
        hits = [f for f in funcs if frag in f]
        if len(hits) != 1:
            raise RuntimeError(f"{name}: {len(hits)} functions match {frag}")
        loop = hot_loop(funcs[hits[0]])
        elems = loop["ldg128"] * vec * K / (K + vec / 2)
        loop["elements"] = elems
        loop["per_element"] = loop["hot_instructions"] / elems
        if clock_mhz:
            loop["issue_floor_ms"] = (loop["per_element"] * C * N * H / (
                SMS * SCHEDULERS * LANES * clock_mhz * 1e6) * 1e3)
        res["flavours"][name] = loop
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", action="append",
                   help="a checkout (repeat to compare); default this one")
    p.add_argument("--clock-mhz", type=float, default=None,
                   help="SM clock for the issue-rate floor (default: the "
                        "card's largest, from nvidia-smi)")
    p.add_argument("--sass-dir", default=None,
                   help="also write each checkout's disassembly here")
    args = p.parse_args(argv)
    roots = args.root or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    clock = args.clock_mhz or card_clock_mhz()
    for root in roots:
        print(json.dumps(count(root, clock, args.sass_dir)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
