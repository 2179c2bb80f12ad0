"""Threshold multiparty CKKS: joint key generation and distributed
decryption, N-of-N by additive shares and t-of-N by Shamir sharing of
them.

Twin of :mod:`ppqsflhe_tpu.ckks.threshold`: the single-device functions
(``:68-303``) and the mesh variants over a ``client`` axis
(:func:`joint_public_key_sharded`, :func:`partial_decrypt_psum`, ``:305-367``),
each rank holding its own parties' shares. The protocol, as OpenFHE's
multiparty surface:

- party i samples a ternary share s_i; the joint secret s = Σ s_i is never
  formed;
- a public common random polynomial ``a`` comes from a shared seed; party i
  publishes b_i = −a·s_i + e_i, and pk = (Σ b_i, a) is an RLWE key for s;
- party i decrypts ct = (c0, c1) partially as p_i = c1·s_i + e_flood
  (uniform smudging noise in ±2^bits), and the fusion decodes c0 + Σ p_i;
- t-of-N: party i Shamir-shares s_i with a degree-(t−1) polynomial of
  uniform ring elements, party j keeps σ_j = Σ_i f_i(j), and any t parties
  decrypt with λ_j·σ_j, λ_j the Lagrange-at-zero scalars of their set.

``a`` must be the JAX package's residues bit for bit, or JAX and port
parties could not share one joint key: :func:`common_random_poly` replays
JAX's draw (:mod:`..core.jax_prng`). Every other draw comes from a
``torch.Generator``. The arithmetic of the key share, the decryption shares
and the Shamir rows sits in helpers that take the sampled values
(:func:`public_share`, :func:`decryption_share`, :func:`shamir_rows`), so
they can be held bit-equal to the JAX functions given the same samples.
Every function takes batched ciphertexts (..., 2, l, N), one fresh flood
per ciphertext. The JAX mesh variants jit their ``shard_map``; on the card
these run as a CUDA graph per (function, context, group and the inputs'
signatures), the psum's all-reduce captured inside
(:func:`..utils.graphs.group_cache`), the floods drawn outside it.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..core import jax_prng, primes, sampling
from ..core.modarith import modadd, modmul, modneg
from ..parallel.mesh import axis_group, psum_mod
from ..utils import graphs
from .multikey import fold_local
from .params import CkksContext
from .rlwe import _poly_mul, _signed_to_eval, decode_coeffs
from .types import Ciphertext, PublicKey, SecretKey

# ``smudging_bits`` is an absolute flood magnitude (partial decryptions
# carry uniform noise in ±2^bits); the statistical distance it buys is
# smudging_bits − decryption_noise_bits (the smudging lemma). See the JAX
# module's note and docs/SECURITY.md.
DEFAULT_SMUDGING_BITS = 30


def decryption_noise_bits(ctx: CkksContext) -> int:
    """A high-probability bound (bits) on the decryption noise of a fresh
    pk encryption: three terms, each a sum of N ternary×Gaussian products of
    std σ√(2N/3), at 6 standard deviations."""
    per_term = 6.0 * ctx.params.sigma * math.sqrt(2.0 * ctx.params.n / 3.0)
    return max(1, math.ceil(math.log2(3.0 * per_term)))


def flood_bits_for_ss(ctx: CkksContext, ss: int, noise_bits: int | None = None) -> int:
    """The flood (bits) that gives ``ss`` bits of statistical distance:
    the decryption-noise bound plus ss."""
    if noise_bits is None:
        noise_bits = decryption_noise_bits(ctx)
    return noise_bits + ss


def smudging_noise(gen: torch.Generator, shape, bits: int, device=None) -> torch.Tensor:
    """Uniform flooding noise in [−2^bits, 2^bits] (int64), one draw of
    ``shape`` (a batch shape plus (N,), or N)."""
    return sampling.uniform_signed(gen, shape, bits, device)


def common_random_poly(ctx: CkksContext, seed: int, device="cuda") -> torch.Tensor:
    """The CRS polynomial ``a`` over the full QP basis, eval domain: the
    JAX package's residues for the same ``seed``."""
    all_idx = tuple(range(len(ctx.moduli_qp)))
    coeff = jax_prng.uniform_rns(seed & 0x7FFFFFFFFFFFFFFF, ctx.moduli_qp, ctx.params.n)
    return ctx.ntt(torch.from_numpy(coeff.view("int64")).to(device), all_idx)


def _all_q(ctx: CkksContext, device):
    return ctx.limb_consts(tuple(range(len(ctx.moduli_qp))), device)


def public_share(ctx: CkksContext, a: torch.Tensor, s_int: torch.Tensor,
                 e_int: torch.Tensor) -> tuple[SecretKey, torch.Tensor]:
    """Party i's round-1 message from its sampled ternary share ``s_int``
    and Gaussian error ``e_int``: (SecretKey s_i, b_i = −a·s_i + e_i over
    QP, eval domain)."""
    all_idx = tuple(range(len(ctx.moduli_qp)))
    q, _, _ = _all_q(ctx, a.device)
    s_eval = _signed_to_eval(ctx, s_int.to(a.device), all_idx)
    e = _signed_to_eval(ctx, e_int.to(a.device), all_idx)
    b = modadd(modneg(_poly_mul(ctx, a, s_eval, all_idx), q), e, q)
    return SecretKey(s_eval=s_eval, s_int=s_int.cpu().numpy().astype("int8")), b


def partial_keygen(ctx: CkksContext, a: torch.Tensor,
                   gen: torch.Generator) -> tuple[SecretKey, torch.Tensor]:
    """Sample s_i (ternary) and e_i (Gaussian), then :func:`public_share`."""
    n = ctx.params.n
    s_int = sampling.ternary(gen, n)
    e_int = sampling.discrete_gaussian(gen, n, ctx.params.sigma)
    return public_share(ctx, a, s_int, e_int)


def joint_public_key(ctx: CkksContext, a: torch.Tensor,
                     b_shares: Sequence[torch.Tensor]) -> PublicKey:
    """pk = (Σ b_i mod q, a)."""
    q, _, _ = _all_q(ctx, a.device)
    b = b_shares[0]
    for bi in b_shares[1:]:
        b = modadd(b, bi, q)
    return PublicKey(data=torch.stack([b, a]))


def _check_two(ct: Ciphertext) -> None:
    if ct.num_components != 2:
        raise ValueError("threshold decryption requires a 2-component ciphertext")


def decryption_share(ctx: CkksContext, ct: Ciphertext, s_eval: torch.Tensor,
                     flood_int: torch.Tensor, lead: bool = False) -> torch.Tensor:
    """p = c1·s + e_flood (+ c0 with ``lead``) over the ciphertext's limbs,
    eval domain, from the sampled flood ``flood_int`` (..., N): one row per
    ciphertext of the batch."""
    _check_two(ct)
    l = ct.nlimbs
    idx = ctx.q_idx(l)
    q, _, _ = ctx.limb_consts(idx, ct.data.device)
    e = _signed_to_eval(ctx, flood_int.to(ct.data.device), idx)
    p = modadd(_poly_mul(ctx, ct.data[..., 1, :, :], s_eval[:l], idx), e, q)
    return modadd(p, ct.data[..., 0, :, :], q) if lead else p


def flood(ctx: CkksContext, ct: Ciphertext, gen: torch.Generator, bits: int,
          device=None) -> torch.Tensor:
    """One flood per ciphertext of the batch, one draw on ``gen``'s device:
    int64[*lead, N], copied to ``device`` (None: left there)."""
    return smudging_noise(gen, tuple(ct.data.shape[:-3]) + (ctx.params.n,), bits, device)


def partial_decrypt(ctx: CkksContext, sk_share: SecretKey, ct: Ciphertext,
                    gen: torch.Generator, smudging_bits: int = DEFAULT_SMUDGING_BITS,
                    lead: bool = False) -> torch.Tensor:
    """Party i's decryption share p_i = c1·s_i + e_flood; ``lead`` folds in
    c0 (MultipartyDecryptLead), so the fusion is a plain Σ."""
    _check_two(ct)
    return decryption_share(ctx, ct, sk_share.s_eval, flood(ctx, ct, gen, smudging_bits), lead)


def fuse_partial_decryptions(ctx: CkksContext, ct: Ciphertext,
                             partials: Sequence[torch.Tensor],
                             include_c0: bool = True) -> torch.Tensor:
    """MultipartyDecryptFusion: the plaintext's coefficient residues
    iNTT(c0 + Σ p_i). ``include_c0=False`` when one partial was made with
    ``lead``."""
    idx = ctx.q_idx(ct.nlimbs)
    q, _, _ = ctx.limb_consts(idx, ct.data.device)
    acc = ct.data[..., 0, :, :] if include_c0 else None
    for p in partials:
        acc = p if acc is None else modadd(acc, p, q)
    return ctx.intt(acc, idx)


def _decode(ctx: CkksContext, coeffs: torch.Tensor, ct: Ciphertext, encoder, num):
    """Decoded slots of one ciphertext, or a list of them for a batch."""
    if coeffs.dim() == 2:
        return decode_coeffs(ctx, coeffs, ct, encoder, num)
    host = coeffs.cpu()
    return [decode_coeffs(ctx, c, ct, encoder, num) for c in host.reshape(-1, *host.shape[-2:])]


def threshold_decrypt(ctx: CkksContext, ct: Ciphertext, sk_shares: Sequence[SecretKey],
                      gen: torch.Generator, encoder, num: int | None = None,
                      smudging_bits: int = DEFAULT_SMUDGING_BITS):
    """Every party's partial decryption, then the fusion and decode (a
    one-host simulation of the N-party protocol)."""
    partials = [partial_decrypt(ctx, sk, ct, gen, smudging_bits) for sk in sk_shares]
    return _decode(ctx, fuse_partial_decryptions(ctx, ct, partials), ct, encoder, num)


# ---------------------------------------------------------------------------
# t-of-N threshold decryption (Shamir over the additive shares)
# ---------------------------------------------------------------------------

def _const_residues(ctx: CkksContext, v: int, device="cuda") -> torch.Tensor:
    """An integer constant as a (L+K, 1) residue column."""
    return ctx.consts(("const", v), lambda: (v % m for m in ctx.moduli_qp), device)


def shamir_rows(ctx: CkksContext, s_eval: torch.Tensor, coeffs: torch.Tensor,
                n_parties: int) -> torch.Tensor:
    """f(j) = s + Σ_m c_m·j^m for j = 1 … n_parties, from the polynomial's
    uniform coefficients ``coeffs`` (t−1, L+K, N) in the coefficient
    domain: int64[n_parties, L+K, N], eval domain (sharing is linear with
    scalar coefficients, so it commutes with the NTT)."""
    all_idx = tuple(range(len(ctx.moduli_qp)))
    dev = s_eval.device
    q, qinv, r2 = _all_q(ctx, dev)
    c_eval = ctx.ntt(coeffs.to(dev), all_idx) if coeffs.shape[0] else coeffs.to(dev)
    rows = s_eval.expand(n_parties, *s_eval.shape)
    for m in range(c_eval.shape[0]):
        jm = torch.stack([_const_residues(ctx, pow(j, m + 1), dev)
                          for j in range(1, n_parties + 1)])      # (n_parties, L+K, 1)
        rows = modadd(rows, modmul(c_eval[m], jm, q, qinv, r2), q)
    return rows.contiguous()


def shamir_share_secret(ctx: CkksContext, sk_share: SecretKey, n_parties: int, t: int,
                        gen: torch.Generator) -> torch.Tensor:
    """Party i's outgoing Shamir shares of its additive share:
    int64[n_parties, L+K, N], row j−1 for party j."""
    if not 1 <= t <= n_parties:
        raise ValueError(f"need 1 <= t <= N, got t={t}, N={n_parties}")
    coeffs = sampling.uniform_rns(gen, ctx.moduli_qp, (t - 1, ctx.params.n))
    return shamir_rows(ctx, sk_share.s_eval, coeffs, n_parties)


def aggregate_received_shares(ctx: CkksContext, incoming: torch.Tensor) -> torch.Tensor:
    """σ_j = Σ_i f_i(j) from ``incoming`` (n_parties, L+K, N)."""
    q, _, _ = _all_q(ctx, incoming.device)
    acc = incoming[0]
    for i in range(1, incoming.shape[0]):
        acc = modadd(acc, incoming[i], q)
    return acc


def lagrange_at_zero(ctx: CkksContext, party_set: Sequence[int], j: int,
                     device="cuda") -> torch.Tensor:
    """λ_j = Π_{j'∈T, j'≠j} j'·(j'−j)^{-1} as a (L+K, 1) residue column."""
    out = []
    for m in ctx.moduli_qp:
        lam = 1
        for jp in party_set:
            if jp != j:
                lam = lam * jp % m * primes.mod_inverse((jp - j) % m, m) % m
        out.append(lam)
    return ctx.consts(("lagrange", tuple(party_set), j), lambda: out, device)


def partial_decrypt_t(ctx: CkksContext, sigma_j: torch.Tensor, ct: Ciphertext,
                      party_set: Sequence[int], j: int, gen: torch.Generator,
                      smudging_bits: int = DEFAULT_SMUDGING_BITS,
                      lead: bool = False) -> torch.Tensor:
    """Party j's t-of-N decryption share for the set T: c1·(λ_j·σ_j) +
    e_flood (+ c0 with ``lead``); fuse with
    :func:`fuse_partial_decryptions`."""
    _check_two(ct)
    return decryption_share(ctx, ct, scaled_sigma(ctx, sigma_j, party_set, j, ct.nlimbs),
                            flood(ctx, ct, gen, smudging_bits), lead)


def check_party(party_set: Sequence[int], j: int) -> None:
    if j not in party_set:
        raise ValueError(f"party {j} not in the participating set {party_set}")


def scaled_sigma(ctx: CkksContext, sigma_j: torch.Tensor, party_set: Sequence[int], j: int,
                 nlimbs: int) -> torch.Tensor:
    """λ_j·σ_j over the first ``nlimbs`` limbs."""
    check_party(party_set, j)
    idx = ctx.q_idx(nlimbs)
    q, qinv, r2 = ctx.limb_consts(idx, sigma_j.device)
    lam = lagrange_at_zero(ctx, party_set, j, sigma_j.device)[:nlimbs]
    return modmul(sigma_j[:nlimbs], lam, q, qinv, r2)


def threshold_decrypt_t(ctx: CkksContext, ct: Ciphertext, sigmas: dict,
                        party_set: Sequence[int], gen: torch.Generator, encoder,
                        num: int | None = None,
                        smudging_bits: int = DEFAULT_SMUDGING_BITS):
    """Any t parties (``party_set``, 1-based) decrypt with their aggregated
    Shamir shares ``sigmas[j]`` (a one-host simulation)."""
    partials = [partial_decrypt_t(ctx, sigmas[j], ct, party_set, j, gen, smudging_bits)
                for j in party_set]
    return _decode(ctx, fuse_partial_decryptions(ctx, ct, partials), ct, encoder, num)


# ---------------------------------------------------------------------------
# Mesh variants: each rank holds its own parties (client axis collectives)
# ---------------------------------------------------------------------------

def joint_public_key_sharded(ctx: CkksContext, a: torch.Tensor, b_local: torch.Tensor, mesh,
                             axis: str = "client") -> PublicKey:
    """pk = (Σ b_i, a) with this rank's public shares ``b_local``
    (parties_local, L+K, N) folded locally and one modular psum over
    ``axis``; the same key on every rank."""
    group = axis_group(mesh, axis)

    def body(a_, b_):
        q, _, _ = _all_q(ctx, b_.device)
        return torch.stack([psum_mod(fold_local(b_, q), q, group), a_])

    return PublicKey(data=graphs.cached(graphs.group_cache(group),
                                        ("joint_public_key_sharded", ctx),
                                        "the mesh function", body, a, b_local))


def partial_decrypt_psum(ctx: CkksContext, ct: Ciphertext, s_eval_local: torch.Tensor,
                         gens_local: Sequence[torch.Generator], mesh, axis: str = "client",
                         smudging_bits: int = DEFAULT_SMUDGING_BITS) -> torch.Tensor:
    """Every party's partial decryption and the fusion as one collective:
    this rank sums c1·s_i + e_i over its parties (``s_eval_local``
    (parties_local, L+K, N), party i's flood from ``gens_local[i]`` as in
    :func:`partial_decrypt`), one modular psum over ``axis``, then c0 is
    added and the iNTT taken. Returns the plaintext's coefficient residues,
    the same on every rank. The floods are drawn first, one call a party on
    its own generator; the shares, the floods and the plaintext are zeroed
    in the graph cache after each call."""
    _check_two(ct)
    idx = ctx.q_idx(ct.nlimbs)
    group = axis_group(mesh, axis)
    floods = torch.stack([flood(ctx, ct, gen, smudging_bits, ct.data.device)
                          for gen in gens_local])

    def body(c, s_stack, e_stack):
        q, _, _ = ctx.limb_consts(idx, c.data.device)
        acc = None
        for s_i, e_i in zip(s_stack, e_stack):
            p = decryption_share(ctx, c, s_i, e_i)
            acc = p if acc is None else modadd(acc, p, q)
        fused = psum_mod(acc, q, group)
        return ctx.intt(modadd(c.data[..., 0, :, :], fused, q), idx)

    return graphs.cached(graphs.group_cache(group), ("partial_decrypt_psum", ctx),
                         "the mesh function", body, ct, s_eval_local, floods, scrub=True)
