"""The plain reference against the program at small rings on the CPU: the
same moduli, roots and evaluation layouts; exact products; and a pairwise
round through the port's eager ``server_round`` judged correct, then
judged wrong once one residue is flipped."""

import numpy as np
import pytest
import torch

from benchmark import generator, program
from benchmark.reference import chain, judge, modq
from benchmark.tests import cells
from ppqsflhe_tpu_torch.ckks.params import CkksContext, CkksParams
from ppqsflhe_tpu_torch.fl.api import server_round


@pytest.mark.parametrize("ext", [0, 20])
@pytest.mark.parametrize("n", [1 << 8, 1 << 14])
def test_chain_is_the_programs(n, ext):
    c = chain.chain(n, 2, 60, 40, 2, ext)
    p = CkksParams.generate(n=n, mult_depth=2, scale_bits=40, dnum=2, extra_mod_bits=ext)
    assert (c.q, c.p, c.ext) == (p.q_moduli, p.p_moduli, p.flexible_ext)


def test_the_extension_prime_is_upstreams():
    c = chain.chain(1 << 14, 2, 60, 40, 2, 20)
    assert (c.q[-1], chain.min_root(1 << 15, c.q[-1])) == (557057, 19)
    assert c.q[0] == 1152921504606748673 and len(c.p) == 2


@pytest.mark.parametrize("order", ["fourstep", "radix2"])
def test_transforms_are_the_programs(order):
    n = 1 << 8
    c = chain.chain(n, 2, 60, 40, 2, 20)
    with pytest.warns(Warning):
        ctx = CkksContext(CkksParams.generate(n=n, mult_depth=2, scale_bits=40, dnum=2,
                                              extra_mod_bits=20, ntt_backend=order))
    g = torch.Generator().manual_seed(5)
    for i, q in enumerate(c.q + c.p):
        psi = chain.min_root(2 * n, q)
        assert psi == ctx.basis.psis[i]
        a = torch.randint(0, q, (3, n), generator=g, dtype=torch.int64)
        evals = modq.forward(a, q, psi, order)
        assert torch.equal(evals, ctx.ntt(a.unsqueeze(-2), (i,))[..., 0, :])
        assert torch.equal(modq.inverse(evals, q, psi, order), a)


def test_mulmod_is_exact():
    g = torch.Generator().manual_seed(9)
    for q in chain.chain(1 << 8, 2, 60, 40, 2, 20).q:
        a, b = (torch.randint(0, q, (2000,), generator=g, dtype=torch.int64) for _ in range(2))
        a[:2], b[:2] = q - 1, q - 1
        want = [int(x) * int(y) % q for x, y in zip(a, b)]
        assert modq.mulmod(a, b, q).tolist() == want


@pytest.mark.parametrize("lazy", [4, 0])
def test_a_round_is_judged(lazy):
    n, clients = 1 << 8, 2
    _, cfg, _, plan = cells.load("pairwise-n14.gru27.lazy4", n)
    c, limits = chain.of(cfg), plan["limits"]
    sec_rng, pay_rng, _, tseed = generator.streams(11)
    secrets = generator.secrets(sec_rng, clients, n)
    pays = generator.payloads(pay_rng, {"payload": {"kind": "vectors", "count": 3},
                                        "input_sets": 1}, clients, n // 2)
    with pytest.warns(Warning):
        sch = program.scheme(cfg, "cpu")
    gen = torch.Generator().manual_seed(tseed)
    (sk0, pk0), (sk1, pk1) = program.keys(sch, secrets, gen)
    ct0, ct1 = (sch.encrypt_values(pk, v, gen) for pk, v in zip((pk0, pk1), pays[0]))
    avg, back = server_round(sch, ct0, ct1, sch.rekey_gen(sk0, pk1, gen),
                             sch.rekey_gen(sk1, pk0, gen), lazy)
    limbs, scale, factor = judge.plan(c, 40, clients, lazy)
    dec = judge.Decryptor(c, "fourstep", secrets, n // 2, "cpu")
    want = factor * judge.fedavg(pays[0])

    def verdict(a, b):
        res = judge.judge(dec, ((a, avg.scale), (b.unsqueeze(0), back.scale)), want, 1, limbs,
                          scale)
        return res, all(res[k] <= limits[k] for k in res)

    res, ok = verdict(avg.data, back.data)
    assert ok and res["max_err"] < 1e-10
    for data, idx in ((avg.data, (1, 0, 0, 17)), (back.data, (2, 1, 0, 3))):
        bad = data.clone()
        bad[idx] = (bad[idx] + 1) % c.q[0]
        res, ok = verdict(bad if data is avg.data else avg.data,
                          bad if data is back.data else back.data)
        assert not ok and res["max_err"] > 1
    if limbs > 1:                    # a residue of another limb: the limbs disagree
        bad = avg.data.clone()
        bad[0, 0, 1, 5] = (bad[0, 0, 1, 5] + 1) % c.q[1]
        res, ok = verdict(bad, back.data)
        assert not ok and res["limb_mismatch"] > 0


def test_fedavg_pads_and_averages():
    out = judge.fedavg([[np.array([1.0, 2.0]), np.array([4.0])],
                        [np.array([3.0, 4.0]), np.array([0.0, 2.0])]])
    assert out.tolist() == [[2.0, 3.0], [2.0, 1.0]]
