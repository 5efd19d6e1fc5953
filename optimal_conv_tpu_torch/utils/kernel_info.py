"""What the compiler made of the port's CUDA kernels.

    python -m optimal_conv_tpu_torch.utils.kernel_info

Needs the CUDA toolkit (``nvcc``, ``cuobjdump``), not a card.  Prints,
for every kernel in ``csrc/*.cu``, the registers, spills and shared
memory that ``nvcc -Xptxas -v`` reports and the opcode mix of its SASS,
and the 32-bit integer instructions of one NTT butterfly and of one
Montgomery product (single and chained): the SASS of a probe kernel that
loads (u, v, w), does the arithmetic with ``csrc/modarith.cuh`` and
stores, less the SASS of the same kernel without the arithmetic; and
the same for one residue of a regenerated key half (``d1``: four
Threefry-2x32 words and two Montgomery products, ``csrc/threefry.cuh``)
and for one element of an NTT cross stage (``xmul``, ``xadd``).
``chip_smoke.py`` turns that count into the kernels' arithmetic bound.
For K1 it also prints the whole kernel's count per element, index
arithmetic and loads included (``mont_kernel_instructions``).
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

from ..core import cuda_lib, mont_kernel

PROBE = r"""
#include <cstdint>
#include "modarith.cuh"
#include "threefry.cuh"
using namespace optconv;
extern "C" __global__ void probe_copy(uint64_t* x, const uint64_t* w,
                                      uint64_t q, uint64_t qi) {
  const int i = threadIdx.x;
  const uint64_t u = x[i], v = x[i + 1024], ww = w[i];
  x[i] = u; x[i + 1024] = v; x[i + 2048] = ww + q + qi;
}
extern "C" __global__ void probe_fwd(uint64_t* x, const uint64_t* w,
                                     uint64_t q, uint64_t qi) {
  const int i = threadIdx.x;
  uint64_t u = x[i], v = x[i + 1024];
  const uint64_t ww = w[i];
  ct_butterfly(u, v, ww, q, q + q, qi);
  x[i] = u; x[i + 1024] = v; x[i + 2048] = ww + q + qi;
}
extern "C" __global__ void probe_inv(uint64_t* x, const uint64_t* w,
                                     uint64_t q, uint64_t qi) {
  const int i = threadIdx.x;
  uint64_t u = x[i], v = x[i + 1024];
  const uint64_t ww = w[i];
  gs_butterfly(u, v, ww, q, q + q, qi);
  x[i] = u; x[i + 1024] = v; x[i + 2048] = ww + q + qi;
}
extern "C" __global__ void probe_mul(uint64_t* x, const uint64_t* w,
                                     uint64_t q, uint64_t qi) {
  const int i = threadIdx.x;
  const uint64_t u = x[i], v = x[i + 1024], ww = w[i];
  x[i] = u; x[i + 1024] = mont_mul(v, ww, q, qi);
  x[i + 2048] = ww + q + qi;
}
extern "C" __global__ void probe_mul2(uint64_t* x, const uint64_t* w,
                                      uint64_t q, uint64_t qi) {
  const int i = threadIdx.x;
  const uint64_t u = x[i], v = x[i + 1024], ww = w[i];
  x[i] = u; x[i + 1024] = mont_mul(mont_mul_lazy(v, ww, q, qi), u, q, qi);
  x[i + 2048] = ww + q + qi;
}
extern "C" __global__ void probe_xmul(uint64_t* x, const uint64_t* w,
                                      uint64_t q, uint64_t qi) {
  const int i = threadIdx.x;
  const uint64_t u = x[i], v = x[i + 1024], ww = w[i];
  x[i] = u; x[i + 1024] = cond_sub(u + mont_mul(v, ww, q, qi), q);
  x[i + 2048] = ww + q + qi;
}
extern "C" __global__ void probe_xadd(uint64_t* x, const uint64_t* w,
                                      uint64_t q, uint64_t qi) {
  const int i = threadIdx.x;
  const uint64_t u = x[i], v = x[i + 1024], ww = w[i];
  x[i] = u; x[i + 1024] = cond_sub(u + v, q);
  x[i + 2048] = ww + q + qi;
}
extern "C" __global__ void probe_d1(uint64_t* x, const uint64_t* w,
                                    uint64_t q, uint64_t qi) {
  const int i = threadIdx.x;
  const uint64_t u = x[i], v = x[i + 1024], ww = w[i];
  x[i] = u; x[i + 1024] = uniform_residue((uint32_t)ww, v, u, q, qi, ww, u);
  x[i + 2048] = ww + q + qi;
}
"""

# opcodes that are not arithmetic of the integer pipe: memory, control,
# special registers and the uniform datapath
_NOT_INT = re.compile(r"^(LD|ST|ATOM|RED|BRA|EXIT|NOP|BAR|S2R|S2UR|CS2R|"
                      r"ULDC|UMOV|UIADD|UIMAD|ULOP|USHF|ULEA|USEL|UISETP|"
                      r"UPLOP|UFLO|WARPSYNC|BSSY|BSYNC|CALL|RET|DEPBAR|"
                      r"MEMBAR|ERRBAR|LEPC|BPT|YIELD|NANOSLEEP|CCTL|R2UR|VOTE"
                      r"|JMP|BRX|BMOV|KILL|PREEXIT|ACQBULK|CGAERRBAR)")


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    path = os.path.join(os.path.dirname(cuda_lib._nvcc()), name)
    if os.path.exists(path):
        return path
    raise RuntimeError(f"{name} not found beside nvcc")


def _compile(src: str, out: str) -> str:
    """nvcc -cubin with -Xptxas -v; returns the compiler's report."""
    flags = [f for f in cuda_lib.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cmd = [cuda_lib._nvcc(), *flags, "-I", str(cuda_lib.CSRC), "-Xptxas", "-v",
           "-cubin", "-o", out, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def sass_opcodes(cubin: str) -> dict[str, collections.Counter]:
    """{function: Counter of opcodes (with their suffixes)} of a cubin."""
    res = subprocess.run([_tool("cuobjdump"), "-sass", cubin],
                         capture_output=True, text=True, check=True)
    out: dict[str, collections.Counter] = {}
    cur = None
    for line in res.stdout.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)",
                     line)
        if m and cur is not None:
            cur[m.group(1)] += 1
    return out


def int_instructions(ops: collections.Counter) -> int:
    return sum(n for op, n in ops.items() if not _NOT_INT.match(op))


def butterfly_instructions() -> dict:
    """32-bit integer instructions of one forward butterfly, one inverse
    butterfly, one Montgomery product, one chained product (the first
    lazily reduced, as K1 does it), one residue of a regenerated key
    half (``d1``) and one element of an NTT cross stage (``xmul``: a
    product and a reduced sum or difference; ``xadd``: the inverse
    stage's lower half, a reduced sum), from the probe kernels' SASS.

    ``issue_slots`` is what bounds their time: the IMAD family issues on
    the FMA pipe and every other integer opcode on the integer ALU pipe,
    64 lanes an SM each, and an SM issues at most 128 thread-instructions
    a clock (one warp instruction per clock in each of its four
    partitions), so an SM needs at least max(alu, fma, all / 2) clocks per
    64 threads' worth.  Counting all at 64 lanes overstated the bound: on
    an H100 SXM the ``d1_regen`` kernel ran in 0.80 of it (347
    instructions a residue, 224 of them on the ALU pipe)."""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cu")
        with open(src, "w") as f:
            f.write(PROBE)
        cubin = os.path.join(tmp, "probe.cubin")
        _compile(src, cubin)
        ops = sass_opcodes(cubin)
    base = int_instructions(ops["probe_copy"])
    out = {}
    for name in ("fwd", "inv", "mul", "mul2", "d1", "xmul", "xadd"):
        mix = ops[f"probe_{name}"] - ops["probe_copy"]
        int32 = int_instructions(ops[f"probe_{name}"]) - base
        fma = sum(n for op, n in mix.items() if op.startswith("IMAD"))
        out[name] = dict(
            int32=int32, fma_pipe=fma, alu_pipe=int32 - fma,
            issue_slots=max(int32 - fma, fma, int32 / 2),
            mix={op: n for op, n in sorted(mix.items())
                 if not _NOT_INT.match(op)})
    return out


def mont_kernel_instructions() -> dict:
    """Whole-kernel SASS counts of every ``mont_mul_kernel`` in
    ``csrc/mont_mul.cu``: all instructions, the integer-pipe part, the
    elements one thread handles in a full tile and the integer
    instructions per element.  The count is static: every instruction
    of the kernel once, index arithmetic, loads and both arms of its
    branches included, so it overstates a tile that skips an arm and
    understates a loop that runs more than once (``per_thread`` is 1
    for a kernel that is not a template: one element a thread a trip).
    Keys are (vec, chained) for a template instance
    ``mont_mul_kernel<VEC, CHAINED>``, else the kernel's name."""
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "mont_mul.cubin")
        _compile(str(cuda_lib.CSRC / "mont_mul.cu"), cubin)
        ops = sass_opcodes(cubin)
    out = {}
    for fn, mix in ops.items():
        if "mont_mul_kernel" not in fn:
            continue
        m = re.search(r"mont_mul_kernelILb([01])ELb([01])EE", fn)
        if m:
            vec, chained = bool(int(m[1])), bool(int(m[2]))
            key = (vec, chained)
            per_thread = mont_kernel.PER_THREAD * (2 if vec else 1)
        else:
            key, per_thread = fn, 1
        int32 = int_instructions(mix)
        out[key] = dict(instructions=sum(mix.values()), int32=int32,
                        per_thread=per_thread,
                        int32_per_element=int32 / per_thread)
    if not out:
        raise RuntimeError("no mont_mul_kernel in the SASS of mont_mul.cu")
    return out


def kernel_reports(sass_dir: str | None = None) -> dict:
    """Per source file: ptxas' report and the opcode mix per kernel.
    With `sass_dir`, the SASS listing of each source is written there."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted(cuda_lib.CSRC.glob("*.cu")):
            cubin = os.path.join(tmp, src.stem + ".cubin")
            report = _compile(str(src), cubin)
            if sass_dir:
                os.makedirs(sass_dir, exist_ok=True)
                with open(os.path.join(sass_dir, src.stem + ".sass"), "w") as f:
                    subprocess.run([_tool("cuobjdump"), "-sass", cubin],
                                   stdout=f, check=True)
            kernels = {}
            for fn, ops in sass_opcodes(cubin).items():
                kernels[fn] = dict(instructions=sum(ops.values()),
                                   int32=int_instructions(ops),
                                   top=dict(ops.most_common(12)))
            out[src.name] = dict(ptxas=report.strip().splitlines(),
                                 kernels=kernels)
    return out


def main(argv=None) -> int:
    """`--sass DIR` also writes each source's SASS listing into DIR."""
    argv = sys.argv[1:] if argv is None else argv
    sass_dir = argv[argv.index("--sass") + 1] if "--sass" in argv else None
    info = dict(butterfly=butterfly_instructions(),
                sources=kernel_reports(sass_dir))
    for name, rep in info["sources"].items():
        print(f"== {name}")
        print("\n".join(rep["ptxas"]))
        for fn, k in rep["kernels"].items():
            print(f"{fn}: {k['instructions']} SASS instructions, "
                  f"{k['int32']} integer; top {k['top']}")
    print(json.dumps({"butterfly": info["butterfly"]}))
    print(json.dumps({"mont_mul_kernel": {
        str(k): v for k, v in mont_kernel_instructions().items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
