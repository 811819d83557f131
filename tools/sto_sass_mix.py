"""The instruction mix of the STO kernels' product loops, of the delay-line
kernel's step loop and of the bf16 flash kernel's two loops, from their SASS.

    python3 tools/sto_sass_mix.py

Builds the kernel library as the wrappers do (src/repro_torch/kernels/_build.py),
disassembles it with cuobjdump -sass and, for rk4_coop_kernel<float> and
<__nv_bfloat16> and field_stage_kernel<float> and <__nv_bfloat16> (field_tiled
and the tiled RK4 stage), finds the k-tile loop: the smallest loop (a backward branch
and its target) holding at least 90 % of the most FFMA (f32) or HMMA (bf16)
instructions any loop holds (the outer loops add the epilogue's). For
that loop it prints the count of each opcode, the share of the math opcode
in all instructions (an upper bound on the issue share the math can reach),
the local-memory (spill) loads and stores inside it, and how many
instructions after each shared-memory load its result is first read. For
tm_delay_line_kernel (sto_delay_line.cu) the same for its innermost loop,
one RK4 step of one lane (the smallest loop holding 90 % of the most FMUL),
whose instruction count a warp issues one a cycle at best. Needs the CUDA
toolkit (nvcc, cuobjdump), not a card.

For flash_bf16<D> (flash_attention.cu) at every head dim it prints the same
for the consumers' KV-tile loop (the smallest loop holding 90 % of the most
HGMMA any loop holds) and the producer's (the same for UTMALDG, the TMA
load), and the whole kernel's HGMMA, UTMALDG and HMMA counts; it exits 1
unless every consumer loop holds HGMMA, every producer loop UTMALDG, and no
flash_bf16 an HMMA (mma.sync).
"""

from __future__ import annotations

import collections
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

KERNELS = {
    "rk4_coop_kernel<float>": ("rk4_coop_kernelIf", "FFMA"),
    "rk4_coop_kernel<bf16>": ("rk4_coop_kernelI13__nv_bfloat16", "HMMA"),
    "field_stage_kernel<float>": ("field_stage_kernelIf", "FFMA"),
    "field_stage_kernel<bf16>": ("field_stage_kernelI13__nv_bfloat16", "HMMA"),
}
# label -> (mangled-name fragment, the opcode whose loop is reported)
STEP_LOOPS = {"tm_delay_line_kernel RK4 step": ("tm_delay_line_kernel", "FMUL")}
FLASH_DIMS = (32, 64, 80, 96, 128, 192, 256)
LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def functions(sass: str) -> dict:
    """Mangled name -> [(address, instruction text)]."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = []
        elif name and (m := LINE.search(line)):
            out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def opcode(text: str) -> str:
    words = text.split()
    return words[1] if words[0].startswith("@") else words[0]


def k_loop(ins, math_op):
    """The smallest backward-branch loop holding at least 90 % of the most
    `math_op` any loop holds (the outer loops add the epilogue's)."""
    index = {addr: i for i, (addr, _) in enumerate(ins)}
    loops = []
    for i, (addr, text) in enumerate(ins):
        m = re.match(r"(?:@!?U?P\w+\s+)?BRA\s+(?:\S+,\s*)?0x([0-9a-f]+)", text)
        if not m or int(m.group(1), 16) >= addr or int(m.group(1), 16) not in index:
            continue
        body = ins[index[int(m.group(1), 16)] : i + 1]
        loops.append((sum(opcode(t).startswith(math_op) for _, t in body), body))
    most = max(count for count, _ in loops)
    return min((body for count, body in loops if count >= 0.9 * most), key=len)


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
    lib = _build.build()
    tool = shutil.which("cuobjdump") or str(pathlib.Path(_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run(
        [tool, "-sass", str(lib)], capture_output=True, text=True, check=True
    ).stdout
    funcs = functions(sass)
    for label, (fragment, math_op) in KERNELS.items():
        name = next(n for n in funcs if fragment in n)
        report(f"{label} k-tile", funcs[name], math_op)
    for label, (fragment, math_op) in STEP_LOOPS.items():
        name = next(n for n in funcs if fragment in n)
        report(label, funcs[name], math_op)
    if not flash(funcs):
        sys.exit("flash_bf16: a consumer loop without HGMMA, a producer loop without UTMALDG, "
                 "or an HMMA left")


if __name__ == "__main__":
    main()
