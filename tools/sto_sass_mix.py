"""The instruction mix of the STO kernels' product loops, of the delay-line
kernel's step loop and of the bf16 flash kernel's two loops, from their SASS.

    python3 tools/sto_sass_mix.py [--src DIR]

Builds the kernel library as the wrappers do (src/repro_torch/kernels/_build.py),
disassembles it with cuobjdump -sass and, for rk4_coop_kernel<float> and
<__nv_bfloat16> and field_stage_kernel<float> and <__nv_bfloat16> (field_tiled
and the tiled RK4 stage), finds the k-tile loop: the smallest loop (a backward branch
and its target) holding at least 90 % of the most FFMA (f32) or HMMA (bf16)
instructions any loop holds (the outer loops add the epilogue's). For
that loop it prints the count of each opcode, the share of the math opcode
in all instructions (an upper bound on the issue share the math can reach),
the local-memory (spill) loads and stores inside it, and how many
instructions after each shared-memory load its result is first read.

For tm_delay_line_kernel (sto_delay_line.cu) it finds every step loop (an
innermost loop holding 90 % of the most FMUL: one RK4 step of one lane;
the kernel's fast node loop and, since its division is inline, its div.rn
rerun) and prints for each its mix, its MUFU, FCHK, CALL, BSSY and BSYNC,
for each MUFU.RCP the FFMAs that refine it into the quotient and the
instructions between the reciprocal and the quotient's first use, and the
step's dependency chain: the longest path through the loop body's register
dependences, counting FADD, FMUL, FFMA and MUFU (`step_chain`), at 4 cycles
an op (chip_smoke.py phase 3f(a) prices it at latencies measured on the
card through `delay_line_chain`). It exits 1 if the fast path, the shortest
step loop, holds a CALL or an FCHK (div.rn's operand check and out-of-line
slow path).

--src DIR imports repro_torch from DIR (default: this checkout's src/), so
an older checkout unpacked beside this one is read with this tool. Needs the
CUDA toolkit (nvcc, cuobjdump), not a card.

For flash_bf16<D> (flash_attention.cu) at every head dim it prints the same
for the consumers' KV-tile loop (the smallest loop holding 90 % of the most
HGMMA any loop holds) and the producer's (the same for UTMALDG, the TMA
load), and the whole kernel's HGMMA, UTMALDG and HMMA counts; it exits 1
unless every consumer loop holds HGMMA, every producer loop UTMALDG, and no
flash_bf16 an HMMA (mma.sync).
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

KERNELS = {
    "rk4_coop_kernel<float>": ("rk4_coop_kernelIf", "FFMA"),
    "rk4_coop_kernel<bf16>": ("rk4_coop_kernelI13__nv_bfloat16", "HMMA"),
    "field_stage_kernel<float>": ("field_stage_kernelIf", "FFMA"),
    "field_stage_kernel<bf16>": ("field_stage_kernelI13__nv_bfloat16", "HMMA"),
}
DELAY = "tm_delay_line_kernel"
# the opcodes a step's dependency chain counts (the rest pass their operands
# on at no cost) and the control opcodes counted in a step loop
CHAIN_OPS = ("FADD", "FMUL", "FFMA", "MUFU")
# the chain's opcodes -> the op of sto_step.tm_latencies that measures each;
# MUFU.RCP is priced as the measured quotient less the FFMAs that refine it
MEASURED = {"FADD": "fadd", "FMUL": "fmul", "FFMA": "ffma"}
CONTROL_OPS = ("MUFU", "FCHK", "CALL", "BSSY", "BSYNC")
FLASH_DIMS = (32, 64, 80, 96, 128, 192, 256)
LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def functions(sass: str, keep=None) -> dict:
    """Mangled name -> [(address, instruction text)], for the functions whose
    name holds `keep` (every function when None)."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if keep is not None and keep not in name:
                name = None
                continue
            out[name] = []
        elif name and (m := LINE.search(line)):
            out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def opcode(text: str) -> str:
    words = text.split()
    return words[1] if words[0].startswith("@") else words[0]


def loops_holding(ins, math_op):
    """Every backward-branch loop holding at least 90 % of the most
    `math_op` any loop holds, as (first, last) indices into `ins`."""
    index = {addr: i for i, (addr, _) in enumerate(ins)}
    loops = []
    for i, (addr, text) in enumerate(ins):
        m = re.match(r"(?:@!?U?P\w+\s+)?BRA\s+(?:\S+,\s*)?0x([0-9a-f]+)", text)
        if not m or int(m.group(1), 16) >= addr or int(m.group(1), 16) not in index:
            continue
        body = ins[index[int(m.group(1), 16)] : i + 1]
        loops.append((sum(opcode(t).startswith(math_op) for _, t in body),
                      (index[int(m.group(1), 16)], i)))
    most = max(count for count, _ in loops)
    return [span for count, span in loops if count >= 0.9 * most]


def k_loop(ins, math_op):
    """The smallest backward-branch loop holding at least 90 % of the most
    `math_op` any loop holds (the outer loops add the epilogue's)."""
    lo, hi = min(loops_holding(ins, math_op), key=lambda span: span[1] - span[0])
    return ins[lo : hi + 1]


def step_loops(ins, math_op="FMUL"):
    """The innermost loops holding at least 90 % of the most `math_op`: each
    such loop that holds no other, in address order."""
    spans = loops_holding(ins, math_op)
    inner = [a for a in spans if not any(b != a and a[0] <= b[0] and b[1] <= a[1] for b in spans)]
    return [ins[lo : hi + 1] for lo, hi in sorted(set(inner))]


def operands(text):
    """(opcode, destination register or None, source registers) of one
    instruction: the first operand is the destination when it is a register
    (stores, branches and predicate writes have none)."""
    words = text.split(None, 2 if text.startswith("@") else 1)
    op, rest = (words[1], words[2:]) if text.startswith("@") else (words[0], words[1:])
    parts = [p.strip() for p in (rest[0] if rest else "").split(",")]
    first = re.match(r"^(R\d+)(?:\.reuse)?$", parts[0]) if parts else None
    dst = first.group(1) if first else None
    srcs = set(re.findall(r"\bR\d+\b", ",".join(parts[1:] if dst else parts)))
    return op, dst, srcs


def step_chain(body, latency=None):
    """The longest path through the register dependences of one pass of a
    step loop's body: (cycles at `latency` {opcode: cycles} of the
    CHAIN_OPS (default 4 each), Counter of the CHAIN_OPS on it). Every other
    instruction passes its
    operands' time on; registers carried in from the last pass start at 0.
    The path follows div.rn's fast path: a branch taken when an FCHK found
    the operands safe (`@!P BRA`) skips the slow-path call it jumps over."""
    latency = latency or dict.fromkeys(CHAIN_OPS, 4.0)
    ready, path, checks, skip_to = {}, {}, set(), -1
    best = (0.0, collections.Counter())
    for addr, text in body:
        if addr < skip_to:
            continue
        op, dst, srcs = operands(text)
        if op.startswith("FCHK"):
            checks.add(text.split()[1].rstrip(","))
        branch = re.match(r"@!(P\d)\s+BRA\s+(?:\S+,\s*)?0x([0-9a-f]+)", text)
        if branch and branch.group(1) in checks and int(branch.group(2), 16) > addr:
            skip_to = int(branch.group(2), 16)
        if dst is None:
            continue
        base = op.split(".")[0]
        src = max(srcs, key=lambda r: ready.get(r, 0.0), default=None)
        t0 = ready.get(src, 0.0) if src else 0.0
        counts = collections.Counter(path.get(src, ()))
        if base in CHAIN_OPS:
            t0 += latency[base]
            counts[base] += 1
        ready[dst], path[dst] = t0, counts
        if t0 > best[0]:
            best = (t0, counts)
    return best


def divisions(body):
    """For each MUFU.RCP of a loop body: (FFMAs that refine its result, each
    reading the sequence's last value, instructions between the reciprocal
    and the first other instruction that reads the quotient)."""
    out = []
    for i, (_, text) in enumerate(body):
        op, dst, _ = operands(text)
        if not op.startswith("MUFU.RCP"):
            continue
        derived, last, ffma = {dst}, dst, 0
        for j in range(i + 1, len(body)):
            op_j, dst_j, srcs_j = operands(body[j][1])
            if op_j.startswith("FFMA") and srcs_j & derived and dst_j:
                derived.add(dst_j)
                last, ffma = dst_j, ffma + 1
            elif last in srcs_j:
                out.append((ffma, j - i - 1))
                break
    return out


def chain_latency(measured, divs):
    """step_chain's {opcode: cycles} from the latencies measured on the card
    (sto_step.tm_latencies: "fadd", "fmul", "ffma", "quotient"): MUFU.RCP is
    the quotient less the FFMAs that refine it (`divisions`), so a division
    on the chain costs the measured quotient."""
    refine = sum(f for f, _ in divs) / max(len(divs), 1)
    latency = {op: measured[name] for op, name in MEASURED.items()}
    latency["MUFU"] = measured["quotient"] - refine * measured["ffma"]
    return latency


def delay_report(ins, measured=None):
    """Print tm_delay_line_kernel's step loops (see the module docstring),
    their chains at 4 cycles an op or, given `measured` (chain_latency), at
    the latencies measured on the card; return the fast loop's summary: its
    steps, control-opcode counts and division chains, its chain's opcodes
    and cycles a step and the latencies it was priced at (None: 4 each)."""
    loops = step_loops(ins)
    fast = min(loops, key=len)
    summary = None
    for body in loops:
        ops = collections.Counter(opcode(t).split(".")[0] for _, t in body)
        rcp = sum(opcode(t).startswith("MUFU.RCP") for _, t in body)
        steps = max(rcp // 4, 1)  # one MUFU.RCP a field evaluation
        divs = divisions(body)
        latency = chain_latency(measured, divs) if measured else None
        cycles, chain = step_chain(body, latency)
        per_step = {k: v / steps for k, v in sorted(chain.items())}
        role = "div.rn rerun" if body is not fast else "fast path" if len(loops) > 1 else "only"
        at = "at 4 an op" if latency is None else "at " + ", ".join(
            f"{k} {v:.2f}" for k, v in latency.items())
        print(f"{DELAY} step loop ({role}) {body[0][0]:#x}-{body[-1][0]:#x}: {len(body)} "
              f"instructions, {steps} RK4 step(s); "
              + ", ".join(f"{k} {ops[k]}" for k in CONTROL_OPS), flush=True)
        print("  opcodes: " + ", ".join(f"{k} {v}" for k, v in ops.most_common(14)), flush=True)
        print(f"  divisions (refining FFMAs, instructions from MUFU.RCP to the quotient's first "
              f"use): {divs}", flush=True)
        print(f"  dependency chain a step: {per_step} = {cycles / steps:.1f} cycles {at}",
              flush=True)
        if body is fast:
            summary = dict(steps=steps, control={k: ops[k] for k in CONTROL_OPS},
                           divisions=divs, chain_per_step=per_step,
                           cycles_per_step=cycles / steps, latency=latency,
                           instructions=len(body))
    return summary


def cuobjdump():
    """The toolkit's cuobjdump, or None where it has none."""
    tool = shutil.which("cuobjdump") or str(pathlib.Path(_nvcc()).parent / "cuobjdump")
    return tool if pathlib.Path(tool).exists() else None


def library_functions(lib, keep=None) -> dict:
    """Mangled name -> instructions, from cuobjdump -sass of the library (the
    functions whose name holds `keep`; every one when None)."""
    sass = subprocess.run(
        [cuobjdump(), "-sass", str(lib)], capture_output=True, text=True, check=True
    ).stdout
    return functions(sass, keep)


def _nvcc():
    from repro_torch.kernels import _build

    return _build._nvcc()


def delay_line_chain(lib, measured) -> dict:
    """The delay-line fast loop's summary (delay_report) from a built
    library, its chain priced at the latencies `measured` on the card."""
    funcs = library_functions(lib, DELAY)
    return delay_report(next(iter(funcs.values())), measured)


def first_use_distances(body):
    """Instructions from each LDS/LDSM to the first read of a register it wrote."""
    out = []
    for i, (_, text) in enumerate(body):
        op = opcode(text)
        if not op.startswith(("LDS", "LDSM")):
            continue
        dst = re.search(r"\s(R\d+),", text)
        if not dst:
            continue
        base = int(dst.group(1)[1:])
        width = 4 if op.endswith((".128", ".4")) else 2 if op.endswith((".64", ".2")) else 1
        regs = {f"R{base + j}" for j in range(width)}
        for j in range(i + 1, len(body)):
            operands = body[j][1].split(None, 2 if body[j][1].startswith("@") else 1)[-1]
            reads = set(re.findall(r"R\d+", operands.split(",", 1)[1] if "," in operands else ""))
            if regs & reads:
                out.append(j - i)
                break
    return out


def report(label, ins, math_op):
    """Print the opcode mix of the loop `k_loop` finds for `math_op` in the
    function `ins`; return that loop."""
    body = k_loop(ins, math_op)
    ops = collections.Counter(opcode(t) for _, t in body)
    math = sum(v for k, v in ops.items() if k.startswith(math_op))
    spills = sum(v for k, v in ops.items() if k.startswith(("LDL", "STL")))
    dist = first_use_distances(body)
    print(f"{label} loop {body[0][0]:#x}-{body[-1][0]:#x}: "
          f"{len(body)} instructions, {math} {math_op} ({math / len(body):.1%}), "
          f"{spills} local loads/stores", flush=True)
    print("  opcodes: " + ", ".join(f"{k} {v}" for k, v in ops.most_common(14)), flush=True)
    if dist:
        print(f"  shared loads to first use (instructions): {len(dist)} loads, "
              f"min {min(dist)}, median {statistics.median(dist)}, max {max(dist)}, "
              f"{sum(d < 16 for d in dist)} under 16", flush=True)
    total = collections.Counter(opcode(t) for _, t in ins)
    local = sum(v for k, v in total.items() if k.startswith(("LDL", "STL")))
    print(f"  whole kernel: {sum(total.values())} instructions, {local} local loads/stores",
          flush=True)
    return body


def flash(funcs) -> bool:
    """flash_bf16 at every head dim: its consumer and producer loops and its
    whole-kernel HGMMA, UTMALDG and HMMA counts. Whether every consumer loop
    holds HGMMA, every producer loop UTMALDG, and no HMMA is left."""
    ok = True
    for d in FLASH_DIMS:
        name = next(n for n in funcs if f"flash_bf16ILi{d}E" in n)
        total = collections.Counter(opcode(t).split(".")[0] for _, t in funcs[name])
        print(f"flash_bf16<{d}> whole kernel: HGMMA {total['HGMMA']}, UTMALDG "
              f"{total['UTMALDG']}, HMMA {total['HMMA']}", flush=True)
        for role, op in (("consumer KV-tile", "HGMMA"), ("producer", "UTMALDG")):
            body = report(f"flash_bf16<{d}> {role}", funcs[name], op)
            ok = ok and any(opcode(t).startswith(op) for _, t in body)
        ok = ok and total["HMMA"] == 0
    return ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="directory holding repro_torch")
    opts = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(opts.src).resolve()))
    from repro_torch.kernels import _build  # the checkout under test

    funcs = library_functions(_build.build())
    for label, (fragment, math_op) in KERNELS.items():
        name = next(n for n in funcs if fragment in n)
        report(f"{label} k-tile", funcs[name], math_op)
    fast = delay_report(funcs[next(n for n in funcs if DELAY in n)])
    failed = []
    if not flash(funcs):
        failed.append("flash_bf16: a consumer loop without HGMMA, a producer loop without "
                      "UTMALDG, or an HMMA left")
    if fast["control"]["CALL"] or fast["control"]["FCHK"]:
        failed.append(f"{DELAY}: the fast step loop holds div.rn's check or call "
                      f"({fast['control']})")
    if failed:
        sys.exit("; ".join(failed))


if __name__ == "__main__":
    main()
