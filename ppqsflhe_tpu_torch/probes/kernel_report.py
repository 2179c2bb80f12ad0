"""Build report of the port's CUDA kernels and kernel 2's time split, on the card.

Prints, for every kernel instance under ``ppqsflhe_tpu_torch/csrc``:

- ``[ptxas]``: the registers, spill bytes and static shared memory that
  ``nvcc -Xptxas -v`` reports for sm_90a (the build flags of
  ``ops/cuda_lib.py``, one nvcc per source, all started together);
- ``[ptxas-instances]``: per NTT kernel template (kernels 1, 1b, 4, 5, 6,
  whose first two template arguments are log2(m) and the tile width TC),
  the count, register range and spilling instances of all its instances,
  of the small rings' (m = 8, 16) and of the narrow tiles' (TC < 16);
- ``[ptxas-note]``: every line ptxas prints about ``wgmma`` or
  ``setmaxnreg`` (a serialization of the wgmmas, an ignored register
  count);
- ``[sass]``: the SASS instruction count of each kernel-2 instance, and for
  each kernel-7 instance (``overlap_probe_kernel``) its count of ``IGMMA``
  (the int8 ``wgmma``, which must be > 0) and ``IMMA`` (``mma.sync``, which
  must be 0) (``cuobjdump -sass`` of the built library);
- ``[sass-wgmma]``: kernel 7's ``IGMMA`` and ``WARPGROUP`` instructions in
  program order, its ``wgmma`` group discipline as compiled;

then kernel 2's device time at the N=2^16 server round's two shapes (the
full-level first digit, 2 → 3 limbs with its constant folded, over 27
polys; ModDown P → Q, 2 → 3 limbs over 54), split three ways and run in
turns (full, bytes-only, arithmetic-only, then back; device time per launch from
torch.profiler): the whole kernel; a variant with the loads and stores and no
arithmetic; and one with the loads and arithmetic and no stores. Needs one
CUDA device, nvcc and cuobjdump. Run from the repository root:

    python3 -m ppqsflhe_tpu_torch.probes.kernel_report
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

N = 1 << 16
ITERS = 50
HBM_BPS = 3.35e12    # H100 SXM device memory, bytes/s


def _tool(name: str) -> str:
    from ..ops import cuda_lib

    path = shutil.which(name) or str(Path(cuda_lib.nvcc()).parent / name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found beside nvcc")
    return path


def _demangle(names):
    if not names:
        return {}
    out = subprocess.run([_tool("cu++filt")], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def ptxas_report() -> tuple:
    """(rows, notes): rows of (source, kernel, registers, spill stores, spill
    loads, smem bytes) per kernel instance; notes, ptxas's lines about
    ``wgmma`` or ``setmaxnreg`` as (source, line)."""
    from ..ops import cuda_lib

    rows, notes = [], []
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(s, subprocess.Popen(
            [cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             str(cuda_lib.CSRC / s), "-o", os.path.join(tmp, f"{s}.o")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for s in cuda_lib.SOURCES]
        for src, p in procs:
            _, err = p.communicate()
            if p.returncode:
                raise RuntimeError(f"nvcc -Xptxas -v {src} failed:\n{err[-4000:]}")
            entry, spill = None, (0, 0)
            for line in err.splitlines():
                if re.search(r"wgmma|setmaxnreg", line, re.IGNORECASE):
                    notes.append((src, line.strip()))
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    entry = m.group(1)
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m:
                    spill = (int(m.group(1)), int(m.group(2)))
                m = re.search(r"Used (\d+) registers", line)
                if m and entry:
                    smem = re.search(r"(\d+) bytes smem", line)
                    rows.append((src, entry, int(m.group(1)), *spill,
                                 int(smem.group(1)) if smem else 0))
                    entry, spill = None, (0, 0)
    names = _demangle([r[1] for r in rows])
    return [(r[0], names.get(r[1], r[1])) + r[2:] for r in rows], notes


def instance_summary(rows) -> list:
    """Lines of :func:`ptxas_report`'s rows grouped per NTT kernel template
    (first template arguments log2(m), TC): all instances, those at m ≤ 16
    and those with TC < 16, each as count, register range and spilling
    count."""
    groups = {}
    for src, name, regs, st, ld, _ in rows:
        m = re.match(r"void <unnamed>::(\w+)<\(int\)(\d+), \(int\)(\d+)", name)
        if m and src in ("mxu_ntt.cu", "streamed_ntt.cu", "fourstep_ntt.cu"):
            g = groups.setdefault((src, m.group(1)), {"all": [], "m <= 16": [], "TC < 16": []})
            rec = (regs, st + ld > 0)
            g["all"].append(rec)
            if int(m.group(2)) <= 4:
                g["m <= 16"].append(rec)
            if int(m.group(3)) < 16:
                g["TC < 16"].append(rec)
    part = lambda recs: (f"{len(recs)} instances, {min(r for r, _ in recs)}-"
                         f"{max(r for r, _ in recs)} registers, {sum(s for _, s in recs)} "
                         f"spilling" if recs else "none")
    return [f"{src} {kernel}: " + "; ".join(f"{k}: {part(v)}" for k, v in g.items())
            for (src, kernel), g in groups.items()]


def sass_opcodes(text: str) -> dict:
    """Per kernel (mangled name) of a ``cuobjdump -sass`` listing, the count
    of each opcode (its first dotted field, predicate dropped)."""
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = {}
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
        if cur and m:
            counts[cur][m.group(1)] = counts[cur].get(m.group(1), 0) + 1
    return counts


def sass_wgmma_sequence(text: str, symbol: str) -> dict:
    """Per kernel (demangled) holding ``symbol``, its ``IGMMA`` and
    ``WARPGROUP`` instructions in program order, runs of IGMMA collapsed:
    the wgmma group discipline as compiled (``WARPGROUP.ARRIVE`` is
    wgmma.fence, ``WARPGROUP.DEPBAR.LE gsb0, n`` a wait_group n)."""
    seqs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            seqs[cur] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?((?:IGMMA|WARPGROUP)\S*)"
                     r"([^;]*);", line)
        if cur and m:
            op = m.group(2)
            if op.startswith("IGMMA"):
                if seqs[cur] and seqs[cur][-1][0] == "IGMMA":
                    seqs[cur][-1][1] += 1
                else:
                    seqs[cur].append(["IGMMA", 1, m.group(1)])
            else:
                arg = m.group(3).strip().split(",")[-1].strip() if "DEPBAR" in op else ""
                seqs[cur].append([op + (f" {arg}" if arg else ""), 0, m.group(1)])
    names = _demangle(list(seqs))
    return {names[k]: " ".join(f"{op}x{n}@{pc}" if n else f"{op}@{pc}" for op, n, pc in v)
            for k, v in seqs.items() if symbol in names[k]}


def sass_counts(lib: Path, symbol: str) -> dict:
    """Opcode counts (:func:`sass_opcodes`) per kernel whose demangled name
    holds ``symbol``."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = sass_opcodes(text)
    names = _demangle(list(counts))
    return {names[k]: v for k, v in counts.items() if symbol in names[k]}


def _device_ms(fn, symbol: str, iters=ITERS) -> float:
    """Mean device ms of the ``symbol`` kernel activities in a torch.profiler
    trace of ``iters`` calls: the kernel's own time, whatever the host's
    launch rate (CUDA events around chained calls would time the host at the
    smaller shape)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e.time_range.elapsed_us() for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA and symbol in e.name]
    if not evs:
        raise RuntimeError(f"the profiler recorded no {symbol} activity")
    return sum(evs) / len(evs) / 1e3


def split_report(card: str) -> None:
    """Kernel 2 whole and split at the N=2^16 round's two shapes."""
    import torch

    from ..ckks.params import CkksParams
    from ..core import primes
    from ..core.rns import BaseExtender
    from ..ops import cuda_ext

    params = CkksParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2, slots=8192)
    q, p = list(params.q_moduli), list(params.p_moduli)
    gen = torch.Generator().manual_seed(7)
    device = torch.device("cuda", 0)
    for src, dst, pre, polys, tag in ((q[:2], q[2:] + p, True, 27, "pre"),
                                      (p, q, False, 54, "ModDown")):
        ext = BaseExtender(src, dst)
        consts = [primes.mod_inverse(7 + i, m) for i, m in enumerate(src)] if pre else None
        x = torch.stack([torch.randint(0, m, (polys, N), generator=gen, dtype=torch.int64)
                         for m in src], dim=1).to(device)
        if not torch.equal(cuda_ext.fused_extend(x, ext, consts), ext.extend(x, consts)):
            raise AssertionError(f"base_extend ({tag}) differs from its plain version")
        runs = {"full": lambda: cuda_ext.fused_extend(x, ext, consts),
                "bytes-only": lambda: cuda_ext.extend_split(x, ext, consts, 1),
                "arithmetic-only": lambda: cuda_ext.extend_split(x, ext, consts, 2)}
        order = ["full", "bytes-only", "arithmetic-only", "arithmetic-only", "bytes-only", "full"]
        t = {k: [] for k in runs}
        for k in order:
            t[k].append(_device_ms(runs[k], "base_extend_kernel"))
        moved = 8 * polys * N * (len(src) + len(dst))
        bound_us = moved / HBM_BPS * 1e6
        print(f"[split base_extend {len(src)}->{len(dst)} limbs, {tag}, {polys} polys, N=2^16] "
              + ", ".join(f"{k} {min(v) * 1e3:.1f} us ({' / '.join(f'{u * 1e3:.1f}' for u in v)})"
                          for k, v in t.items())
              + f"; bytes bound {bound_us:.1f} us ({moved / 1e6:.1f} MB): full at "
              f"{bound_us / (min(t['full']) * 1e3):.0%}, bytes-only at "
              f"{bound_us / (min(t['bytes-only']) * 1e3):.0%} ({card})")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_report: torch.cuda.is_available() is False — needs a CUDA GPU")
    from ..ops import cuda_lib

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(f"[card] {card}")
    rows, notes = ptxas_report()
    for src, name, regs, st, ld, smem in rows:
        print(f"[ptxas] {src} {name}: {regs} registers, spill {st}/{ld} bytes (stores/loads), "
              f"{smem} bytes static smem")
    for line in instance_summary(rows):
        print(f"[ptxas-instances] {line}")
    for src, line in notes:
        print(f"[ptxas-note] {src}: {line}")
    if not any(src == "overlap_probe.cu" for src, _ in notes):
        print("[ptxas-note] overlap_probe.cu: no line about wgmma or setmaxnreg")
    lib = cuda_lib.build()
    cuda_lib.library()
    for name, ops in sass_counts(lib, "base_extend").items():
        print(f"[sass] {name}: {sum(ops.values())} instructions")
    for name, ops in sass_counts(lib, "overlap_probe_kernel").items():
        igmma, imma = ops.get("IGMMA", 0), ops.get("IMMA", 0)
        vpu = int(re.search(r"<\(int\)(\d+)>", name).group(1)) & 3 == 1   # no products
        ok = imma == 0 and (igmma == 0 if vpu else igmma > 0)
        print(f"[sass] {name}: {sum(ops.values())} instructions, IGMMA {igmma}, IMMA {imma}"
              + ("" if ok else " -- expected IMMA == 0 and IGMMA > 0 (0 in the vpu order)"))
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    for name, seq in sass_wgmma_sequence(text, "overlap_probe_kernel").items():
        print(f"[sass-wgmma] {name.split('>(')[0]}>: {seq or 'none'}")
    split_report(card)


if __name__ == "__main__":
    sys.exit(main())
