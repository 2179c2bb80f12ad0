"""Three gaps of the port against the JAX package, each held to it:

- ``CkksContext`` warns with ``SecurityWarning`` below 128-bit HE-standard
  security, with the JAX text, and ``CkksParams.security_bits`` gives the
  JAX estimate (twin of ``tests/test_ckks.py::test_insecure_params_warning``);
- ``fl.cli train <config>`` trains the ``CLIENT`` section of a client
  config (the JAX CLI's ``train``) on a numpy-seeded CSV;
- ``train.mlp.num_params`` and ``train.transformer.num_params`` equal the
  JAX functions' counts.
"""

import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ckks.params import CkksContext as JaxContext
from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams
from ppqsflhe_tpu.ckks.params import SecurityWarning as JaxSecurityWarning
from ppqsflhe_tpu.train import gru as jgru
from ppqsflhe_tpu.train import mlp as jmlp
from ppqsflhe_tpu.train import transformer as jtransformer
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks.params import CkksContext, CkksParams, SecurityWarning
from ppqsflhe_tpu_torch.fl import cli
from ppqsflhe_tpu_torch.train import mlp, transformer

from test_torch_train import client_cfg, write_csv


def test_insecure_params_warning():
    """Context build surfaces the HE-standard security estimate when the
    chain falls below 128-bit; the reference-sized chain builds quietly."""
    tiny = CkksParams.generate(n=256, mult_depth=2, scale_bits=40, dnum=2)
    with pytest.warns(SecurityWarning, match="below 128-bit") as got:
        CkksContext(tiny)
    jtiny = JaxParams.generate(n=256, mult_depth=2, scale_bits=40, dnum=2)
    with pytest.warns(JaxSecurityWarning) as want:
        JaxContext(jtiny)
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    assert "N=256, log2(QP)=260" in str(got[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("error", SecurityWarning)
        CkksContext(CkksParams.reference())


@pytest.mark.parametrize("n,depth,extra", [(256, 2, 0), (1 << 12, 2, 0), (1 << 13, 2, 0),
                                           (1 << 14, 2, 0), (1 << 14, 2, 20), (1 << 14, 6, 0),
                                           (1 << 15, 2, 0), (1 << 16, 2, 0), (1 << 17, 2, 0)])
def test_security_bits_equal_jax(n, depth, extra):
    p = CkksParams.generate(n=n, mult_depth=depth, extra_mod_bits=extra)
    jp = JaxParams(**convert.params_fields(p))
    assert p.security_bits() == jp.security_bits()
    assert CkksParams.reference().security_bits() == JaxParams.reference().security_bits()


def test_cli_train(tmp_path):
    """``--device cpu --seed 3 train <config>`` trains the CLIENT section
    and writes its weights export, as the JAX CLI does."""
    csv = write_csv(str(tmp_path / "d.csv"))
    cfg = client_cfg(str(tmp_path), csv, epochs=2)
    path = tmp_path / "c_config.json"
    path.write_text(json.dumps({"CLIENT": cfg}))
    assert cli.main(["--device", "cpu", "--seed", "3", "train", str(path)]) == 0
    with open(cfg["INPUT_WEIGHTS_PATH"]) as f:
        summary = json.load(f)["weights_summary"]
    assert len(summary) == 8 and all(np.isfinite(e["values"]).all() for e in summary)
    # the GRU at hidden 8 over 7 features: the export holds the JAX layout
    want = jgru.init_params(jax.random.PRNGKey(0), 7, hidden=8)
    assert [e["shape"] for e in summary] == [list(np.shape(w)) for w in want]
    assert os.path.getsize(cfg["INPUT_WEIGHTS_PATH"]) > 0


@pytest.mark.parametrize("family", ["mlp", "transformer"])
def test_num_params_equal_jax(family):
    jmod, mod = {"mlp": (jmlp, mlp), "transformer": (jtransformer, transformer)}[family]
    for kw in ({}, {"hidden": 8}):
        if family == "mlp":
            kw = dict(kw, lookback=12)
        jp = jmod.init_params(jax.random.PRNGKey(0), 7, **kw)
        p = mod.init_params(torch.Generator().manual_seed(0), 7, **kw)
        assert mod.num_params(p) == jmod.num_params(jp) > 0
        assert mod.num_params(convert.train_params_np(p)) == jmod.num_params(jp)
