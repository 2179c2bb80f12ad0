"""Traffic: everything a run feeds the program, made from ``--seed``.

One general generator reads a traffic file (``traffic/<name>.json``):

- ``payload``: each client's weights as slot vectors. ``{"kind":
  "vectors", "count": c}`` is c vectors filling every slot (the reference
  GRU export at 8192 slots, 27 ciphertexts); ``{"kind": "layers",
  "shapes": [...]}`` is a Keras export of those weight shapes, per layer a
  [mean], a [std] and the values in slot-sized chunks (the stacked LSTM,
  154 ciphertexts). Values are uniform(−1, 1).
- ``input_sets``: how many distinct encrypted inputs each client has in the
  pool that the window cycles through.
- ``lazy``: the schedule (4: upstream ``LAZY_LEVELS``; 0: OpenFHE's round).

The secrets are uniform ternary. The seed feeds one ``SeedSequence``
whose children give the secrets, the payloads, the sample of checked
rounds and the seed of the program's own draws (a, e, u: a
``torch.Generator`` on the card)."""

from __future__ import annotations

import math

import numpy as np


def streams(seed: int):
    """(secrets rng, payload rng, sample rng, torch seed) from ``seed``
    (any whole number)."""
    kids = np.random.SeedSequence(seed % (1 << 64)).spawn(4)
    torch_seed = int(kids[3].generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)
    return (*(np.random.default_rng(k) for k in kids[:3]), torch_seed)


def secrets(rng, clients: int, n: int) -> np.ndarray:
    """Each client's ternary secret, int8 (clients, n) in {−1, 0, 1}."""
    return rng.integers(-1, 2, size=(clients, n), dtype=np.int8)


def vectors(rng, count: int, slots: int) -> list:
    """``count`` full vectors (copied from
    ``ppqsflhe_tpu_torch/bench/server_round.py`` ``payload``)."""
    return [rng.uniform(-1, 1, slots) for _ in range(count)]


def layers(rng, shapes, slots: int) -> list:
    """One client's export in a Keras layout (copied from
    ``ppqsflhe_tpu_torch/bench/multikey.py`` ``payloads``)."""
    vecs = []
    for shape in shapes:
        v = rng.uniform(-1, 1, math.prod(shape))
        vecs += [np.array([v.mean()]), np.array([v.std()])]
        vecs += [v[c * slots : (c + 1) * slots] for c in range(-(-v.size // slots))]
    return vecs


def payloads(rng, traffic: dict, clients: int, slots: int) -> list:
    """[input set][client] → that client's vectors."""
    p = traffic["payload"]
    make = {"vectors": lambda: vectors(rng, p["count"], slots),
            "layers": lambda: layers(rng, p["shapes"], slots)}[p["kind"]]
    return [[make() for _ in range(clients)] for _ in range(traffic["input_sets"])]
