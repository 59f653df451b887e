#!/usr/bin/env python3
"""Ablations of the port's dampen_int8_rowscale kernel on one NVIDIA card.

    python3 tools/rowscale_variants.py    # from the repository root, one card

The committed source src/repro_torch/kernels/csrc/dampen.cu is built as it
is and with one part changed, with the same nvcc flags as kernels/build.py,
into kernels/_build/variants/ (tools/dampen_variants.py::build_variants),
and the rowscale C entry is called directly on tables laid out by
kernels/dampen.py::rowscale_plan:

  base          the committed source: the grouped kernel's body over a
                table of parts, 1024 elements per block, 4 per thread, a
                quad's row from the host's multiplier, a scale load per
                element
  epb2048       2048 elements per block (the table laid out for it)
  ept16         16 elements per thread: 64 threads per block, 1024
                elements per block
  fs_per_quad   one scale load for a quad that lies in one row
  hw_divide     a quad's row by the 32-bit divide e / C instead of the
                multiplier
  own_kernel    a kernel of its own: one part as its parameter, no table
                and no search, 32-bit indices throughout
  search        a one-part leaf launched as a table of 16 (the row found by
                a search over a table read at run-time offsets), not as a
                table of one

Each variant is first held bit for bit against the plain version
(kernels/dampen.py::dampen_int8_rowscale_ref) at every timed shape and at
small shapes with short, odd and misaligned rows. Then the device time
(launches queued behind a spin kernel) at the largest leaf of full-width
ResNet-18 as the [fisher kernels] phase of chip_smoke.py runs it, [512,
4608], and at the same element count in rows of 27 (the stem's row
length, where 3 quads in 4 cross a row end), each on four operand sets
rotated beyond the L2, beside the byte bound (10 bytes per element plus
the scale table). Beside them, timed only, as yardsticks: no_dequant, the
committed source with the quad path's dequantisation taken out (wrong
codes, the same bytes), and the grouped int8 kernel (dampen_int8, one
leaf, no count) on the same operands with i_fq as its i_f (one byte more
an element: the mask). Last, cuobjdump -sass of the committed and the
hw_divide libraries: per rowscale kernel its CALL sites, the opcodes of
the routines they call and whether it divides; the run fails if the
committed kernel divides an integer or calls a routine that the grouped
int8 kernel does not (or if the hw_divide kernel shows no divide: the
check would be blind). Prints one line per measurement and a last JSON
line with every time in microseconds.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import dampen_variants as dv  # noqa: E402

MEMORY_RATE = 3.35e12   # H100 SXM device memory, bytes/s (data sheet)
ROW_OF = "return __umulhi(e << 1, m.mul) >> m.shr;"
# a kernel of its own for one part: the same helpers, no table
OWN_KERNEL = r'''
namespace {
__global__ void __launch_bounds__(kThreads)
    rowscale_own_kernel(const __grid_constant__ RowLeaf leaf, float alpha,
                        float lam) {
  const int8_t* theta = static_cast<const int8_t*>(leaf.theta);
  const float* __restrict__ i_f = leaf.i_f;
  const float* __restrict__ i_g = leaf.i_g;
  int8_t* out = static_cast<int8_t*>(leaf.out);
  const RowMap rows = row_map(leaf);
  const unsigned n = unsigned(leaf.n);
  const unsigned start = blockIdx.x * unsigned(kElemsPerBlock);
  const unsigned end = min(start + unsigned(kElemsPerBlock), n);
  unsigned head = start;
  unsigned char m;
  if (leaf.vec) {
    const Vec4<int8_t>* th4 = reinterpret_cast<const Vec4<int8_t>*>(theta);
    const float4* f4 = reinterpret_cast<const float4*>(i_f);
    const float4* g4 = reinterpret_cast<const float4*>(i_g);
    Vec4<int8_t>* o4 = reinterpret_cast<Vec4<int8_t>*>(out);
    for (unsigned k = start / 4 + threadIdx.x; k < end / 4; k += kThreads) {
      const Vec4<int8_t> t = th4[k];
      const float4 f = dequantise(rows, 4 * k, f4[k]);
      const float4 g = g4[k];
      Vec4<int8_t> o;
      o.v[0] = dampen_one(t.v[0], f.x, g.x, alpha, lam, &m);
      o.v[1] = dampen_one(t.v[1], f.y, g.y, alpha, lam, &m);
      o.v[2] = dampen_one(t.v[2], f.z, g.z, alpha, lam, &m);
      o.v[3] = dampen_one(t.v[3], f.w, g.w, alpha, lam, &m);
      o4[k] = o;
    }
    head = end / 4 * 4 > start ? end / 4 * 4 : start;
  }
  for (unsigned k = head + threadIdx.x; k < end; k += kThreads) {
    const float f = __fmul_rn(i_f[k], rows.fs[row_of(rows, k)]);
    out[k] = dampen_one(theta[k], f, i_g[k], alpha, lam, &m);
  }
}
}  // namespace

extern "C" int rowscale_own(const long long* rows, int n_parts,
                            long long blocks, float alpha, float lam,
                            void* stream) {
  if (n_parts != 1) return int(cudaErrorInvalidValue);
  RowLeaf leaf{};
  fill(leaf, rows);
  rowscale_own_kernel<<<unsigned(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(leaf, alpha,
                                                             lam);
  return int(cudaGetLastError());
}
'''
# one scale load for a quad that lies in one row
FS_PER_QUAD = """  if (c + 3 < m.C) {
    const float s = *fs;
    return make_float4(__fmul_rn(f.x, s), __fmul_rn(f.y, s),
                       __fmul_rn(f.z, s), __fmul_rn(f.w, s));
  }
  float v[4] = {f.x, f.y, f.z, f.w};"""
VARIANTS = {
    "epb2048": [(dv.EPB, "constexpr int kElemsPerBlock = 2048;")],
    "ept16": [("constexpr int kThreads = 256;",
               "constexpr int kThreads = 64;"),
              (dv.EPB, "constexpr int kElemsPerBlock = 1024;")],
    "fs_per_quad": [("  float v[4] = {f.x, f.y, f.z, f.w};", FS_PER_QUAD)],
    "hw_divide": [(ROW_OF, "return e / m.C;")],
    "own_kernel": [(None, OWN_KERNEL)],
    "search": [("if (n_parts == 1) {", "if (false) {")],
    "no_dequant": [("if constexpr (kRows) f = dequantise",
                    "if constexpr (false) f = dequantise")],
}
UNCHECKED = ("no_dequant", "dampen_int8")
# the elements per block that a variant's table is laid out for, where it
# is not the committed ELEMS_PER_BLOCK
EPBS = {"epb2048": 2048}
ENTRY = "ficabu_dampen_int8_rowscale"
ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
        ctypes.c_float, ctypes.c_void_p]
# an integer divide in SASS: the unsigned 32- or 64-bit reciprocal that
# starts nvcc's inline 32-bit sequence and its 64-bit division routine
INT_DIVIDE = re.compile(r"\bI2F\.U(32|64)\.RP\b")
INSTRUCTION = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_kernels(so: Path, nvcc: str):
    """Per kernel of the library (its mangled name): the number of CALL
    sites, the opcodes of each routine they call (from its first
    instruction to its RET), and whether the kernel, routines included,
    holds an integer divide."""
    tool = Path(nvcc).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    kernels = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        at = {int(a, 16): (op, rest) for a, op, rest in
              INSTRUCTION.findall(block)}
        calls = [int(t, 16) for op, rest in at.values()
                 if op.startswith("CALL")
                 for t in re.findall(r"0x([0-9a-f]+)", rest)]
        routines = []
        for target in sorted(set(calls)):
            ops = []
            for a in sorted(x for x in at if x >= target):
                ops.append(at[a][0])
                if ops[-1].startswith("RET"):
                    break
            routines.append(sorted(set(ops)))
        kernels[name] = {"call_sites": len(calls), "routines": routines,
                         "int_divide": bool(INT_DIVIDE.search(block))}
    return kernels


def check_no_divide(kernels):
    """No rowscale kernel of a library's sass_kernels (the table of one and
    the table of 16) divides an integer, and every routine it calls is one
    that the grouped int8 kernel calls too (whose source divides no
    integer: the slow path of the correctly rounded f32 divide)."""
    rows = [v for k, v in kernels.items() if "kernelIaNS_7RowLeaf" in k]
    grouped = [v for k, v in kernels.items() if "kernelIaNS_4Leaf" in k]
    if not rows or len(grouped) != 1:
        raise RuntimeError(f"rowscale / grouped int8 kernels not found: "
                           f"{list(kernels)}")
    for rep in rows:
        if rep["int_divide"] or any(r not in grouped[0]["routines"]
                                    for r in rep["routines"]):
            raise AssertionError(f"a committed rowscale kernel divides: "
                                 f"{rep} (grouped int8: {grouped[0]})")


def main() -> int:
    if not torch.cuda.is_available():
        print("rowscale_variants: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import dampen as kd

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    built = dv.build_variants(kb, VARIANTS, {"rowscale": ENTRY}, ARGS,
                              prefix="rowscale")
    fns = {name: fn["rowscale"] for name, (_, fn) in built.items()}
    fns["own_kernel"] = kb.bind(ctypes.CDLL(str(built["own_kernel"][0])),
                                "rowscale_own", ARGS)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    alpha, lam = 0.5, 0.5

    def operands(R, C, lo=0):
        th = torch.randint(-128, 128, (R * C + lo,), generator=gen,
                           device=dev, dtype=torch.int8)[lo:].view(R, C)
        i_fq = torch.randint(0, 128, (R * C + lo,), generator=gen,
                             device=dev).float()[lo:].view(R, C)
        fs = torch.rand(R, generator=gen, device=dev) * 0.05
        i_g = torch.rand(R * C + lo, generator=gen,
                         device=dev)[lo:].view(R, C)
        return th, i_fq, fs, i_g

    def prepared(args, epb):
        """The launch's table and its output, laid out for epb."""
        th, i_fq, fs, i_g = args
        out = torch.empty_like(th)
        with dv.elems_per_block(kd, epb):
            rows, blocks = kd.rowscale_plan(
                *th.shape, (th.data_ptr(), i_fq.data_ptr(), fs.data_ptr(),
                            i_g.data_ptr(), out.data_ptr()))
        return rows, blocks, out

    def launch(fn, prep):
        rows, blocks, _ = prep
        if fn(rows.ctypes.data, len(rows), blocks, alpha, lam, stream) != 0:
            raise RuntimeError("launch failed")

    timed = {"[512, 4608]": (512, 4608), "[87382, 27]": (87382, 27)}
    sets = {key: [operands(*shape) for _ in range(4)]
            for key, shape in timed.items()}
    checks = [s[0] for s in sets.values()] + [
        operands(R, C, lo) for R, C in ((64, 27), (3500, 1), (1800, 2),
                                        (5, 1025), (7, 300), (1, 1))
        for lo in (0, 1)]
    runs = {name: (lambda prep, fn=fn: launch(fn, prep),
                   lambda args, name=name: prepared(
                       args, EPBS.get(name, kd.ELEMS_PER_BLOCK)))
            for name, fn in fns.items()}
    int8 = kb.bind(ctypes.CDLL(str(built["base"][0])),
                   "ficabu_dampen_group_int8", dv.GROUP_ARGS)

    def int8_prepared(args):
        """One leaf's table for the grouped int8 kernel, its output and
        mask."""
        th, i_fq, _, i_g = args
        out, mask = torch.empty_like(th), torch.empty_like(th)
        (rows, blocks), = kd.table_plan(
            [th.numel()], [(th.data_ptr(), i_fq.data_ptr(), i_g.data_ptr(),
                            out.data_ptr(), mask.data_ptr())], 1)
        return rows, blocks, out, mask

    def int8_launch(prep):
        rows, blocks = prep[:2]
        if int8(rows.ctypes.data, 1, blocks, alpha, lam, None, stream) != 0:
            raise RuntimeError("launch failed")

    runs["dampen_int8"] = (int8_launch, int8_prepared)
    result = {}
    for name, (run, prepare) in runs.items():
        for args in checks if name not in UNCHECKED else ():
            prep = prepare(args)
            run(prep)
            torch.cuda.synchronize()
            if not torch.equal(prep[2], kd.dampen_int8_rowscale_ref(
                    *args, alpha, lam)):
                raise AssertionError(f"rowscale {name} != plain at "
                                     f"{tuple(args[0].shape)}")
        result[name] = {}
        for key, group in sets.items():
            preps = [prepare(args) for args in group]
            rot = iter(range(1 << 30))
            result[name][key] = dv.device_us(
                lambda: run(preps[next(rot) % 4]), 200)
        print(f"[variant] {name}: " + (
            "timed only" if name in UNCHECKED else
            f"bit-identical to plain at {len(checks)} shapes") + "; " +
            ", ".join(f"{key} {us:.2f} us"
                      for key, us in result[name].items()), flush=True)
    bound = {key: (10 * R * C + 4 * R) / MEMORY_RATE * 1e6
             for key, (R, C) in timed.items()}
    print(f"[bound] bytes at {MEMORY_RATE / 1e12} TB/s: " + ", ".join(
        f"{key} {us:.2f} us" for key, us in bound.items()), flush=True)

    sass = {name: sass_kernels(built[name][0], kb._nvcc())
            for name in ("base", "hw_divide")}
    for name, kernels in sass.items():
        for kernel, rep in kernels.items():
            print(f"[sass] {name} {kernel}: {rep['call_sites']} CALL sites "
                  f"to {len(rep['routines'])} routines "
                  f"{rep['routines']}; integer divide "
                  f"{'present' if rep['int_divide'] else 'absent'}",
                  flush=True)
    check_no_divide(sass["base"])
    if not any(v["int_divide"] for k, v in sass["hw_divide"].items()
               if "RowLeaf" in k):
        raise AssertionError("no integer divide found in the hw_divide "
                             "kernel: the check cannot see one")
    print(json.dumps({"device": smi, "device_us": result, "bound_us": bound,
                      "sass": sass}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
