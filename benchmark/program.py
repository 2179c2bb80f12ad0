"""The program under test (``ppqsflhe_tpu_torch``) as the benchmark drives
it: the scheme a configuration file states, each client's keys made from
the benchmark's own ternary secret through the port's public draw/body
split (``rlwe.keygen_draws`` for the public a and the error e,
``rlwe.keygen_body``, ``rlwe.keys_of``); rekeys and encryptions are the
scheme's own (``rekey_gen``, ``encrypt_values``)."""

from __future__ import annotations

import numpy as np
import torch

from ppqsflhe_tpu_torch.ckks import rlwe
from ppqsflhe_tpu_torch.ckks.params import CkksParams
from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme


def scheme(cfg: dict, device) -> CkksScheme:
    """The scheme the configuration states."""
    if cfg["PREMode"] != "INDCPA":
        raise ValueError(f"PREMode {cfg['PREMode']!r}: the benchmark's entries run INDCPA")
    params = CkksParams.generate(
        n=cfg["ring_dim"], mult_depth=cfg["multiplicative_depth"],
        scale_bits=cfg["scaling_mod_size"], first_mod_bits=cfg["first_mod_size"],
        dnum=cfg["dnum"], slots=cfg["batch_size"], extra_mod_bits=cfg.get("extra_mod_size", 0),
        ntt_impl=cfg["ntt_impl"], ntt_backend=cfg["ntt_backend"])
    return CkksScheme(params, device=device)


def keys(sch: CkksScheme, secrets: np.ndarray, gen: torch.Generator) -> list:
    """(secret key, public key) per row of ``secrets`` (ternary, (C, N))."""
    out = []
    for s in secrets:
        _, a, e = rlwe.keygen_draws(sch.ctx, gen, sch.device)
        s_int = torch.as_tensor(s.astype(np.int32), device=sch.device)
        out.append(rlwe.keys_of(s_int, *rlwe.keygen_body(sch.ctx, s_int, a, e)))
    return out

