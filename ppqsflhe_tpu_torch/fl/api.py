"""The server's two tools, in memory, and the composed aggregation round.

Twins of the compute cores of ``ppqsflhe_tpu.fl.api.change_cipher_domain``
(``fl/api.py:527-552``) and ``aggregate_encrypted_weights`` (``:855-873``),
on batched ciphertexts (leading dimension = the ciphertexts of one client's
payload) instead of files: the wire formats wait for the port of
``ckks/serialize.py``. :func:`server_round` composes them the way
``bench.py``'s ``server_round`` does (``bench.py:197-222``).
"""

from __future__ import annotations

from typing import Sequence

from ..ckks import eval as ev
from ..ckks.scheme import CkksScheme
from ..ckks.types import Ciphertext, KeySwitchKey


def change_cipher_domain_batch(sch: CkksScheme, rekey: KeySwitchKey, cts: Ciphertext,
                               drop_limbs: int = 0,
                               keep_limbs: int | None = None) -> Ciphertext:
    """ReEncrypt every ciphertext of the batch ``cts`` (data (B, 2, l, n))
    into the rekey's target domain, after an optional LevelReduce:
    ``drop_limbs`` removes top limbs, ``keep_limbs`` keeps exactly that many.
    The rekey should already be in Montgomery form (``ev.ksk_to_mont``)."""
    l = cts.nlimbs
    if keep_limbs is not None:
        if not 1 <= keep_limbs <= l:
            raise ValueError(f"keep_limbs={keep_limbs} outside [1, {l}]")
        drop_limbs = l - keep_limbs
    if drop_limbs:
        if drop_limbs >= l:
            raise ValueError(f"cannot drop {drop_limbs} of {l} limbs")
        cts = ev.level_reduce(sch.ctx, cts, l - drop_limbs)
    return sch.re_encrypt(cts, rekey)


def aggregate_batch(sch: CkksScheme, stacks: Sequence[Ciphertext], lazy: bool) -> Ciphertext:
    """Homomorphic FedAvg over clients' batches, all in one key domain:
    Σ_i ct_i · (1/N). Every input is first LevelReduced to the common
    minimum level. With ``lazy`` and N a power of two, ÷N is exact scale
    metadata and one more limb is LevelReduced off the output; otherwise it
    is EvalMult(1/N) + rescale."""
    n_clients = len(stacks)
    scale = stacks[0].scale
    lmin = min(s.nlimbs for s in stacks)
    acc = ev.level_reduce(sch.ctx, stacks[0], lmin)
    for s in stacks[1:]:
        acc = ev.add(sch.ctx, acc, ev.level_reduce(sch.ctx, s, lmin))
    if lazy and (n_clients & (n_clients - 1)) == 0 and lmin > 1:
        return Ciphertext(acc.data[..., : lmin - 1, :], scale=scale * n_clients)
    return ev.mult_scalar(sch.ctx, acc, 1.0 / n_clients)


def server_round(sch: CkksScheme, stack1: Ciphertext, stack2: Ciphertext,
                 rk12: KeySwitchKey, rk21: KeySwitchKey, lazy: int = 4):
    """The server's encrypted-aggregation round over two clients' batches:
    PRE 1→2, FedAvg, PRE back to 1. Returns (average in client 2's domain,
    average re-encrypted to client 1).

    ``lazy=4`` (the default schedule): LevelReduce one limb, PRE with one
    digit, add, ÷2 as scale metadata plus LevelReduce, PRE at one limb.
    ``lazy=0``: the full-level schedule — PRE with every digit, add,
    mult_scalar(0.5) + rescale, PRE one level down."""
    if lazy not in (0, 4):
        raise ValueError(f"lazy={lazy}: only the 4 and 0 schedules are ported")
    drop = min(1, sch.params.num_q - 1) if lazy else 0
    c1in2 = change_cipher_domain_batch(sch, rk12, stack1, drop_limbs=drop)
    avg = aggregate_batch(sch, [c1in2, stack2], lazy=bool(lazy))
    return avg, change_cipher_domain_batch(sch, rk21, avg)
