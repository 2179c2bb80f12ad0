"""Build report of the port's CUDA kernels and kernel 2's time split, on the card.

Prints, for every kernel instance under ``ppqsflhe_tpu_torch/csrc``:

- ``[ptxas]``: the registers, spill bytes and static shared memory that
  ``nvcc -Xptxas -v`` reports for sm_90a (the build flags of
  ``ops/cuda_lib.py``, one nvcc per source, all started together);
- ``[sass]``: the SASS instruction count of each kernel-2 instance
  (``cuobjdump -sass`` of the built library);

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


def ptxas_report() -> list:
    """(source, kernel, registers, spill stores, spill loads, smem bytes) per
    kernel instance."""
    from ..ops import cuda_lib

    rows = []
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
    return [(r[0], names.get(r[1], r[1])) + r[2:] for r in rows]


def sass_counts(lib: Path, symbol: str) -> dict:
    """SASS instructions per kernel whose demangled name holds ``symbol``."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[cur] += 1
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
    for src, name, regs, st, ld, smem in ptxas_report():
        print(f"[ptxas] {src} {name}: {regs} registers, spill {st}/{ld} bytes (stores/loads), "
              f"{smem} bytes static smem")
    lib = cuda_lib.build()
    cuda_lib.library()
    for name, count in sass_counts(lib, "base_extend").items():
        print(f"[sass] {name}: {count} instructions")
    split_report(card)


if __name__ == "__main__":
    sys.exit(main())
