"""Kernel 7's plain version against the TPU probe's kernel body.

``probes/mxu_vpu_overlap.py`` runs its measurement when it is imported, and
its ``make`` returns only the scan's carry, so the test lifts ``vpu_chain``,
the inner ``kernel`` and its ``pl.pallas_call`` out of the file with
``ast`` (the file stays as it is) and runs them in interpret mode at small
shapes (m=16, nd=2, c=32, K=3). Exact uint32 outputs, tolerance 0, for the
four kinds with carry 0 and non-zero; the uint32 → int8 carry conversion is
pinned to what XLA's convert gives."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ppqsflhe_tpu_torch.ops import cuda_lib
from ppqsflhe_tpu_torch.probes import mxu_vpu_overlap as probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, ND, C, K = 16, 2, 32, 3


def _tpu_probe_call():
    """build(kind) → the TPU probe's pallas_call at this file's shapes."""
    with open(os.path.join(REPO, "probes", "mxu_vpu_overlap.py")) as f:
        tree = ast.parse(f.read())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    make = funcs["make"]
    kernel = next(n for n in make.body if isinstance(n, ast.FunctionDef))
    call = next(n for n in make.body
                if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "f")
    build = ast.FunctionDef(
        name="build", args=ast.arguments(posonlyargs=[], args=[ast.arg("kind")],
                                         kwonlyargs=[], kw_defaults=[], defaults=[]),
        body=[kernel, call, ast.Return(ast.Name("f", ast.Load()))], decorator_list=[],
        type_params=[])
    mod = ast.fix_missing_locations(ast.Module(body=[funcs["vpu_chain"], build],
                                               type_ignores=[]))
    ns = dict(jax=jax, jnp=jnp, np=np, pl=pl, pltpu=pltpu, m=M, nd=ND, c=C, h=C // 2, K=K,
              Z=np.int32(0))
    exec(compile(mod, "probes/mxu_vpu_overlap.py", "exec"), ns)
    return ns["build"]


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    a = rng.integers(-100, 100, (ND * M, ND * M), dtype=np.int8)
    x8 = rng.integers(0, 100, (K, ND * M, C), dtype=np.int8)
    return _tpu_probe_call(), a, x8


def test_carry_conversion_matches_xla():
    """uint32 → int8 keeps the low byte, two's complement, as XLA's convert."""
    vals = np.array([0, 0x7F, 0x80, 0xFF, 0x1FF, 300, 0xFFFFFF80, 0xFFFFFFFF], np.uint32)
    want = np.asarray(jnp.asarray(vals).astype(jnp.int8)).tolist()
    got = [probe.carry_byte(torch.tensor([int(v)], dtype=torch.int64)) for v in vals]
    assert got == want
    bits = torch.from_numpy(vals.view(np.int32).copy())         # as the kernel stores them
    assert [probe.carry_byte(bits[i : i + 1]) for i in range(len(vals))] == want


@pytest.mark.parametrize("kind", probe.KINDS)
@pytest.mark.parametrize("chained", [False, True], ids=["carry0", "carry"])
def test_plain_matches_tpu_kernel(world, kind, chained):
    """probe_plain equals the TPU kernel body on X8 ^ carry; with ``chained``
    the carry is a previous output's [0, 0, 0] (non-zero here)."""
    build, a, x8 = world
    prev = None
    carry = np.int8(0)
    if chained:
        with pltpu.force_tpu_interpret_mode():
            o = build("serial")(jnp.asarray(x8), jnp.asarray(a))
        carry = np.asarray(o[0, 0, 0].astype(jnp.int8))
        prev = torch.from_numpy(np.asarray(o).view(np.int32).copy())
        assert carry != 0
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(build(kind)(jnp.asarray(x8 ^ carry), jnp.asarray(a)))
    got = probe.probe_plain(kind, torch.from_numpy(x8), torch.from_numpy(a), prev, m=M)
    assert got.dtype == torch.int32 and got.shape == (K, M, C)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    if kind in ("serial", "inter"):
        other = probe.probe_plain("inter" if kind == "serial" else "serial",
                                  torch.from_numpy(x8), torch.from_numpy(a), prev, m=M)
        assert torch.equal(got, other)


def test_wrapper_stays_off_the_card(world):
    """On CPU tensors the wrapper runs the plain version: no build, no
    launch; an unknown kind raises."""
    _, a, x8 = world
    before = probe.launches
    x, at = torch.from_numpy(x8), torch.from_numpy(a)
    assert torch.equal(probe.probe("inter", x, at, m=M), probe.probe_plain("inter", x, at, m=M))
    with pytest.raises(ValueError, match="kind"):
        probe.probe("both", x, at, m=M)
    assert probe.launches == before and cuda_lib._lib is None
