#!/usr/bin/env python3
"""Count the instructions the compiler emitted for each of the port's CUDA
kernels, by opcode, from ``cuobjdump -sass`` of the built kernel library.

    python3 tools/sass_mix.py                 # every kernel
    python3 tools/sass_mix.py rss_gate bit2a  # kernels whose name holds a word
    python3 tools/sass_mix.py --compare OTHER.so

It builds the library first (``repro_torch.kernels.build()``, which needs
``nvcc`` and ``cuobjdump``), then prints, per kernel (its demangled name, so
a template's ring-32 and ring-64 builds stand apart), the count of each
opcode family (the opcode without its modifiers, with ``IMAD.WIDE`` kept
apart) in the whole function, and the integer-arithmetic total (``IMAD*``,
``IADD3``, ``LOP3``, ``SHF``, ``LEA``). These are static counts of the
function body. The 32-bit instruction counts per 64-bit operation that
``chip_smoke.py``'s ``wide_cost`` states for the 64-bit builds' bounds (two
for an AND, XOR, add or shift, three for a multiply) were read from this
output.

``--compare`` holds every kernel of another build of the library against
this one: each of its kernels' instruction streams, without addresses, must
be the stream of a ring-32 kernel here (kernels are matched by their code,
so a kernel that became a template on the word type still matches its
older self). To get the build of an older commit, unpack it into a
directory git ignores and build it there, on a machine with ``nvcc``::

    mkdir -p _checkout/parent && git archive <commit> | tar -x -C _checkout/parent
    (cd _checkout/parent && python3 -c "import sys; sys.path.insert(0, 'src'); \\
        from repro_torch.kernels import build; print(build())")
    python3 tools/sass_mix.py --compare \\
        _checkout/parent/src/repro_torch/kernels/_build/librepro_torch_kernels.so
"""
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

INT_FAMILIES = ("IMAD", "IMAD.WIDE", "IADD3", "LOP3", "SHF", "LEA", "IMUL")


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return str(Path("/usr/local/cuda/bin") / name)


def sass_listing(lib: Path) -> dict:
    """{demangled function name: [instruction text, ...]} (no addresses)."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    funcs: dict = {}
    current = None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = m.group(1)
            funcs[current] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+([^;]*);", line)
        if current and m:
            funcs[current].append(" ".join(m.group(1).split()))
    names = list(funcs)
    demangled = subprocess.run([_tool("cu++filt")], input="\n".join(names), capture_output=True, text=True)
    if demangled.returncode == 0:
        pretty = demangled.stdout.splitlines()
        if len(pretty) == len(names):
            funcs = {p: funcs[n] for p, n in zip(pretty, names)}
    return funcs


def opcode_mix(instructions) -> Counter:
    """Opcode families of an instruction list (a predicate guard dropped)."""
    mix: Counter = Counter()
    for ins in instructions:
        op = ins.split()[1] if ins.startswith("@") else ins.split()[0]
        mix["IMAD.WIDE" if op.startswith("IMAD.WIDE") else op.split(".")[0]] += 1
    return mix


def compare(lib: Path, other: Path) -> int:
    """Hold each kernel of ``other`` against the ring-32 kernels of ``lib``."""
    mine = {n: ins for n, ins in sass_listing(lib).items() if "unsigned long" not in n}
    same = differ = 0
    for name, ins in sorted(sass_listing(other).items()):
        match = next((m for m, here in mine.items() if here == ins), None)
        if match:
            same += 1
            print(f"same: {name} = {match} ({len(ins)} instructions)")
        else:
            differ += 1
            print(f"DIFFERENT: {name} ({len(ins)} instructions): no kernel here compiles to them")
    print(f"{same} kernels compile to the same instructions, {differ} do not")
    return 0 if differ == 0 else 1


def main(argv) -> int:
    from repro_torch.kernels import build

    lib = build()
    if len(argv) == 3 and argv[1] == "--compare":
        return compare(lib, Path(argv[2]))
    funcs = sass_listing(lib)
    words = argv[1:]
    for name in sorted(funcs):
        if words and not any(w in name for w in words):
            continue
        ops = opcode_mix(funcs[name])
        arith = sum(ops[f] for f in INT_FAMILIES)
        top = ", ".join(f"{k} {v}" for k, v in ops.most_common(12))
        print(f"{name}\n    integer arithmetic {arith}; {top}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
