"""Every kernel launch of the port goes on PyTorch's current stream, so a
CUDA graph capture (``fl/compiled.py``) records it, and no launch lands on
the legacy default stream, which a capture refuses. Checked without a card:

- every C entry point in ``ops/cuda_lib._SIGNATURES`` takes the stream as
  its last argument, a ``void*`` both in its ctypes signature and in its
  ``extern "C"`` definition under ``csrc/``;
- every ``<<<…>>>`` launch in ``csrc/`` names a stream (four launch
  arguments, the last not ``0``);
- every Python call of an entry point passes ``cuda_lib.stream_of(…)`` as
  that argument, and every entry point has such a call;
- ``stream_of`` gives ``torch.cuda.current_stream(device).cuda_stream``.
"""

import ast
import re
from pathlib import Path

import pytest
import torch

from ppqsflhe_tpu_torch.ops import cuda_lib

PKG = Path(cuda_lib.__file__).resolve().parents[1]
STREAM_ARG = cuda_lib._P


def _c_entry_points() -> dict:
    """name → parameter list of every ``extern "C"`` function in csrc/."""
    out = {}
    for src in sorted(cuda_lib.CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            out[m.group(1)] = [p.strip() for p in m.group(2).split(",")]
    return out


def _top_level_args(s: str) -> list:
    args, depth, cur = [], 0, ""
    for ch in s:
        if ch == "," and depth == 0:
            args.append(cur.strip())
            cur = ""
            continue
        depth += ch in "(<[" and 1 or ch in ")>]" and -1 or 0
        cur += ch
    return args + [cur.strip()]


def _launch_calls():
    """(file, line, entry point or None, last argument) of every call of a
    loaded entry point in the package: ``lib.ppq_x(…)`` or
    ``getattr(lib, name)(…)``."""
    calls = []
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in cuda_lib._SIGNATURES:
                name = f.attr
            elif (isinstance(f, ast.Call) and isinstance(f.func, ast.Name)
                  and f.func.id == "getattr" and isinstance(f.args[0], ast.Name)
                  and f.args[0].id == "lib"):
                name = None
            else:
                continue
            calls.append((path.relative_to(PKG.parent), node.lineno, name, node.args[-1], path))
    return calls


def test_every_entry_point_takes_the_stream_last():
    c_defs = _c_entry_points()
    assert set(c_defs) == set(cuda_lib._SIGNATURES)
    for name, args in cuda_lib._SIGNATURES.items():
        assert args[-1] is STREAM_ARG, f"{name}: ctypes signature does not end in the stream"
        assert c_defs[name][-1] == "void* stream", f"{name}: C definition ends in {c_defs[name][-1]}"
        assert len(c_defs[name]) == len(args), f"{name}: {len(c_defs[name])} C parameters, " \
            f"{len(args)} in ctypes"


def test_every_kernel_launch_names_a_stream():
    launches = 0
    for src in sorted(cuda_lib.CSRC.glob("*.cu")):
        for m in re.finditer(r"<<<(.*?)>>>", src.read_text(), re.S):
            args = _top_level_args(m.group(1))
            assert len(args) == 4 and args[-1] not in ("0", "nullptr", "NULL"), \
                f"{src.name}: launch <<<{m.group(1)}>>> on the default stream"
            launches += 1
    assert launches >= len(cuda_lib._SIGNATURES) - 1   # mxu_ntt.cu's two share one launch


def test_every_python_launch_passes_the_current_stream():
    calls = _launch_calls()
    launched = set()
    for rel, line, name, last, path in calls:
        assert (isinstance(last, ast.Call) and isinstance(last.func, ast.Attribute)
                and last.func.attr == "stream_of"
                and isinstance(last.func.value, ast.Name) and last.func.value.id == "cuda_lib"), \
            f"{rel}:{line}: the launch's last argument is not cuda_lib.stream_of(...)"
        if name is None:      # getattr(lib, name): the names the module spells out
            text = path.read_text()
            launched |= {n for n in cuda_lib._SIGNATURES if f'"{n}"' in text}
        else:
            launched.add(name)
    assert launched == set(cuda_lib._SIGNATURES)


@pytest.mark.parametrize("index", [None, 1])
def test_stream_of_is_the_current_stream(monkeypatch, index):
    """Through a stub of ``torch.cuda.current_stream``: the handle handed to
    the kernel is the current stream of the tensor's device."""
    seen = []

    class Stream:
        cuda_stream = 0x5EED

    def current_stream(device=None):
        seen.append(device)
        return Stream()

    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    t = torch.zeros(2)
    if index is not None:
        t = type("T", (), {"device": torch.device("cuda", index)})()
    assert cuda_lib.stream_of(t) == 0x5EED
    assert seen == [t.device]
