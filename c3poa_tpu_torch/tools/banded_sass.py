"""SASS instructions a DP row of the banded forward kernel, by pipe.

    python -m c3poa_tpu_torch.tools.banded_sass [W=128]

(``row_pipes`` reads the row loop of any kernel the same way;
``chip_smoke.py`` reads the profile kernel's with it.)

Reads ``cuobjdump -sass`` of the built ``kernels/csrc/banded.cu`` (needs
nvcc and cuobjdump; no card), finds the row loop of the forward kernel's
instance for band W — the innermost loop that holds a warp shuffle, the
largest such before the kernel's first EXIT (the loop for pairs whose
target is shorter than the band lies after it; a test holds the reading
to a saved dump of the built kernel) — and follows the shortest and the
longest path through one
iteration (one row): the body is a graph of basic blocks, because a row
takes one arm of the band-shift switch (an indirect branch: its arms are
taken to be the blocks nothing else leads to) and only every eighth row
stores its move words.  Instructions are counted as issued (a predicated-off
instruction still takes its issue slot) and sorted by the pipe that
executes them on an sm_90 SM sub-partition:

  alu   integer and logic (IADD3, LOP3, ISETP, SEL, VIMNMX, VIADDMNMX,
        SHF, PRMT, LEA, MOV...): 16 lanes, a warp instruction every 2
        clocks
  fma   IMAD, IDP (dp4a) and float multiply-add: a second pipe, so a
        mix of alu and fma issues up to twice as fast as alu alone
  xu    conversions and MUFU (the float band placement)
  shfl  warp shuffles;  lds  shared-memory loads and stores;
  mem   global and local memory;  ctrl  branches, barriers;
  uni   the uniform datapath;  other  everything else
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter

from ..kernels import _build

PIPES = ("alu", "fma", "xu", "shfl", "lds", "mem", "ctrl", "uni", "other")
_FMA = ("IMAD", "IDP", "FFMA", "FMUL", "FADD", "HFMA", "HADD", "HMUL",
        "IMUL")
_XU = ("MUFU", "I2F", "F2I", "FRND", "F2F", "POPC", "FLO", "BREV")
_ALU = ("IADD", "LOP", "ISETP", "SEL", "VIMNMX", "VIADD", "IMNMX", "SHF",
        "SHL", "SHR", "PRMT", "LEA", "MOV", "PLOP", "P2R", "R2P", "FSETP",
        "FSEL", "FMNMX", "IABS", "I2FP", "SGXT", "BMSK", "VABSDIFF",
        "FCHK", "CSEL", "ICMP", "FCMP", "PSETP")
_CTRL = ("BRA", "BRX", "JMP", "BSSY", "BSYNC", "WARPSYNC", "CALL", "RET",
         "EXIT", "BAR", "NOP", "YIELD", "DEPBAR", "BREAK", "NANOSLEEP",
         "LDGDEPBAR", "ERRBAR", "MEMBAR")


def pipe_of(mnemonic: str) -> str:
    """The pipe of one SASS opcode (modifiers after the first dot are
    ignored)."""
    op = mnemonic.split(".")[0]
    if op.startswith("SHFL"):
        return "shfl"
    if op in ("LDS", "STS", "LDSM", "ATOMS"):
        return "lds"
    if op.startswith(("LDG", "STG", "LDL", "STL", "LD", "ST", "ATOM", "RED",
                      "LDC")) and not op.startswith("LDGDEPBAR"):
        return "mem"
    if op.startswith(("S2UR", "R2UR")) or (
            op.startswith("U") and len(op) > 1 and not op.startswith("UN")):
        return "uni"
    if op.startswith(_CTRL):
        return "ctrl"
    if op.startswith(_FMA):
        return "fma"
    if op.startswith(_XU):
        return "xu"
    if op.startswith(_ALU):
        return "alu"
    return "other"


def _target(insn: str):
    """The address a branch names, or None."""
    if "0x" not in insn:
        return None
    try:
        return int(insn.split("0x")[-1].split()[0].rstrip(",;"), 16)
    except ValueError:
        return None


def _unconditional(insn: str) -> bool:
    """A transfer that never falls through to the next instruction."""
    op = _build.sass_mnemonic(insn)
    if insn.split()[0].startswith("@") or ".DIV" in op:
        return False
    return op.startswith(("BRA", "BRX", "JMP", "JMX", "EXIT", "RET"))


def loops_of(body, skip_exits: int = 0):
    """(head, tail) address pairs of the backward branches of a kernel,
    up to its first unconditional EXIT (what follows is out-of-line code:
    the divergent arms of BRA.DIV and called subroutines, which branch
    back into the body without being loops); ``skip_exits`` unconditional
    EXITs before it are passed over (early returns)."""
    exits = [a for a, i in body if _unconditional(i) and
             _build.sass_mnemonic(i).startswith("EXIT")]
    end = exits[skip_exits] if len(exits) > skip_exits else None
    out = []
    for addr, insn in body:
        if end is not None and addr > end:
            break
        if _build.sass_mnemonic(insn).startswith("BRA"):
            t = _target(insn)
            if t is not None and t <= addr:
                out.append((t, addr))
    return out


def row_loop(body, skip_exits: int = 0):
    """The row loop: of the loops that hold a shuffle and no other loop
    that holds one, the one with the most instructions (``loops_of``
    says which EXIT ends the search)."""
    def has_shfl(lo, hi):
        return any(lo <= a <= hi and
                   _build.sass_mnemonic(i).startswith("SHFL")
                   for a, i in body)
    loops = [lp for lp in loops_of(body, skip_exits) if has_shfl(*lp)]
    inner = [(lo, hi) for lo, hi in loops
             if not any((a, b) != (lo, hi) and lo <= a and b <= hi
                        for a, b in loops)]
    if not inner:
        raise RuntimeError("no loop with a warp shuffle")
    return max(inner, key=lambda lp: sum(lp[0] <= a <= lp[1]
                                         for a, _ in body))


def loop_paths(body, lo: int, hi: int):
    """Instruction counts by pipe along the shortest and the longest
    path through one iteration of the loop [lo, hi] (hi: the address of
    its backward branch).  Returns (min Counter, max Counter, Counter of
    every instruction in the loop)."""
    insns = [(a, i) for a, i in body if lo <= a <= hi]
    addrs = [a for a, _ in insns]
    index = {a: n for n, a in enumerate(addrs)}
    # the arms of an indirect branch (a switch's jump table): the blocks
    # that nothing falls into and no direct branch names
    named = {_target(i) for _, i in insns
             if _build.sass_mnemonic(i).startswith(("BRA", "JMP"))}
    arms = [addrs[n + 1] for n, (_, i) in enumerate(insns[:-1])
            if _unconditional(i) and addrs[n + 1] not in named]
    # successors of each instruction, forward edges inside the loop only
    succ = {}
    bssy = {}
    for n, (a, insn) in enumerate(insns):
        op = _build.sass_mnemonic(insn)
        pred = insn.split()[0].startswith("@")
        nxt = [addrs[n + 1]] if n + 1 < len(addrs) else []
        t = _target(insn)
        if op.startswith(("BRX", "JMX")):
            t = None
        if op.startswith("BSSY"):
            bssy[insn.split()[-2].rstrip(",") if "," in insn else ""] = t
            succ[a] = nxt
        elif op.startswith(("BRX", "JMX")):
            succ[a] = [t for t in arms if t > a]
        elif op.startswith("BRA") or op.startswith("JMP"):
            # BRA.DIV and predicated branches may fall through
            cond = pred or ".DIV" in op
            out = list(nxt) if cond else []
            if t is not None and a < t <= hi and t in index:
                out.append(t)
            succ[a] = out
        elif op.startswith("BSYNC"):
            reg = insn.split()[-1]
            t = bssy.get(reg)
            succ[a] = [t] if t is not None and a < t <= hi and \
                t in index else nxt
        elif op.startswith(("EXIT", "RET")) and not pred:
            succ[a] = []
        else:
            succ[a] = nxt
    total = Counter(pipe_of(_build.sass_mnemonic(i)) for _, i in insns)
    best = {lo: (Counter(), Counter())}
    for a, insn in insns:
        if a not in best:
            continue
        here = Counter([pipe_of(_build.sass_mnemonic(insn))])
        mn, mx = best[a][0] + here, best[a][1] + here
        if a == hi:
            return mn, mx, total
        for s in succ[a]:
            if s not in best:
                best[s] = (mn, mx)
            else:
                omn, omx = best[s]
                best[s] = (mn if sum(mn.values()) < sum(omn.values())
                           else omn,
                           mx if sum(mx.values()) > sum(omx.values())
                           else omx)
    raise RuntimeError("the loop's backward branch is not reachable")


def row_pipes(funcs: dict, key: str, skip_exits: int = 0) -> dict:
    """{"min": {...}, "max": {...}, "loop": {...}} SASS instructions by
    pipe of one iteration of the row loop of the first kernel whose name
    holds ``key`` (past ``skip_exits`` early returns), and "opcodes":
    {opcode: count} of every instruction in the loop."""
    body = next((v for k, v in funcs.items() if key in k), None)
    if body is None:
        raise RuntimeError(f"no kernel {key} in the library")
    lo, hi = row_loop(body, skip_exits)
    mn, mx, total = loop_paths(body, lo, hi)

    def table(c):
        d = {p: c.get(p, 0) for p in PIPES}
        d["all"] = sum(c.values())
        return d
    ops = Counter(_build.sass_mnemonic(i).split(".")[0] for a, i in body
                  if lo <= a <= hi)
    return {"min": table(mn), "max": table(mx), "loop": table(total),
            "opcodes": dict(ops.most_common())}


def forward_row_pipes(funcs: dict, band: int = 128) -> dict:
    """``row_pipes`` of the forward kernel's instance for ``band``."""
    return row_pipes(funcs, f"banded_fwd_kernelILi{band // 32}E")


def format_row_pipes(res: dict) -> list:
    cols = ("all",) + PIPES
    lines = ["path " + " ".join(f"{c:>5}" for c in cols)]
    for name in ("min", "max", "loop"):
        lines.append(f"{name:>4} " + " ".join(f"{res[name][c]:>5}"
                                              for c in cols))
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="SASS instructions a row of the banded forward kernel, "
                    "by pipe.")
    p.add_argument("W", type=int, nargs="?", default=128)
    args = p.parse_args(argv)
    res = forward_row_pipes(_build.sass("banded"), args.W)
    print(f"banded forward, W = {args.W}: SASS instructions a row and warp "
          f"(min / max path through the row loop; loop = every instruction "
          f"in it)")
    for line in format_row_pipes(res):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
