"""High-level CKKS facade, the twin of ``ppqsflhe_tpu.ckks.scheme``: encoding
and decoding (fresh full-level plaintexts at Δ·q_ext under FLEXIBLEAUTOEXT,
whose extension limb is dropped before any multiplication), keygen,
rekey_gen, relinearization, rotation and conjugation keys, encrypt_values,
decrypt, add, sub, add_plain, mult_plain, mult_scalar, ct×ct mult,
rescale, rotations (plain, hoisted, rotation sums), conjugation, the packed
inner product, and re_encrypt in both PRE modes. Operations run eagerly on
the device their tensors live on; the scheme's ``device`` is where it
creates new ones: the card unless the caller asks for another
(``device="cpu"`` runs the plain versions). Randomness comes from explicit
``torch.Generator``s.
"""

from __future__ import annotations

import numpy as np
import torch

from . import eval as ev
from . import rlwe
from ..core.modarith import modadd
from .encoding import Encoder
from .params import CkksContext, CkksParams
from .types import Ciphertext, KeySwitchKey, Plaintext, PublicKey, SecretKey


class CkksScheme:
    def __init__(self, params: CkksParams, device="cuda"):
        self.params = params
        self.device = torch.device(device)
        self.ctx = CkksContext(params)
        self.encoder = Encoder(params.n, params.slots or params.n // 2)

    # -- encoding -----------------------------------------------------------

    def make_plaintext(self, values, nlimbs: int | None = None,
                       scale: float | None = None) -> Plaintext:
        """One real vector, or a list of them (→ a batched plaintext), to
        eval-domain residues over the first ``nlimbs`` Q limbs. Under
        FLEXIBLEAUTOEXT a fresh full-level plaintext encodes at Δ·q_ext."""
        l = nlimbs or self.params.num_q
        if scale is None:
            scale = self.params.scale
            if self.params.flexible_ext and l == self.params.num_q:
                scale *= float(self.params.q_moduli[-1])
        batched = isinstance(values, (list, tuple))
        coeffs = self.encoder.encode_batch(values if batched else [values], scale)
        rns = self.encoder.to_rns_batch(coeffs, self.ctx.moduli_qp[:l])   # (B, l, n)
        data = torch.as_tensor(rns.view(np.int64), device=self.device)
        data = self.ctx.ntt(data if batched else data[0], self.ctx.q_idx(l))
        return Plaintext(data=data, scale=scale)

    def decode(self, coeffs_centered, scale: float, num: int | None = None) -> np.ndarray:
        """Centered integer coefficients (host) → real slot values."""
        return self.encoder.decode(coeffs_centered, scale, num).real

    # -- keys ---------------------------------------------------------------

    def keygen(self, gen: torch.Generator,
               a_seed: bytes | None = None) -> tuple[SecretKey, PublicKey]:
        return rlwe.keygen(self.ctx, gen, self.device, a_seed)

    def rekey_gen(self, sk_from: SecretKey, pk_to: PublicKey,
                  gen: torch.Generator) -> KeySwitchKey:
        """Proxy re-encryption key A→B from A's secret and B's public key
        (INDCPA PRE)."""
        L = self.params.num_q
        return ev.keyswitch_key_gen(self.ctx, sk_from.s_eval[:L], gen, pk_to=pk_to)

    def relin_key_gen(self, sk: SecretKey, gen: torch.Generator) -> KeySwitchKey:
        """Key switching s² → s, for relinearizing a ct×ct product."""
        L = self.params.num_q
        s = sk.s_eval[:L]
        s2 = rlwe._poly_mul(self.ctx, s, s, tuple(range(L)))
        return ev.keyswitch_key_gen(self.ctx, s2, gen, sk_to=sk)

    def _galois_key(self, sk: SecretKey, g: int, gen: torch.Generator) -> KeySwitchKey:
        s_g = ev.automorphism(self.ctx, sk.s_eval[: self.params.num_q], g)
        return ev.keyswitch_key_gen(self.ctx, s_g, gen, sk_to=sk)

    def rotation_key_gen(self, sk: SecretKey, rotations, gen: torch.Generator) -> dict:
        """Keys for slot rotations (EvalRotateKeyGen), by rotation."""
        return {r: self._galois_key(sk, ev.rot_to_galois(r, self.params.n), gen)
                for r in rotations}

    def conjugation_key_gen(self, sk: SecretKey, gen: torch.Generator) -> KeySwitchKey:
        return self._galois_key(sk, 2 * self.params.n - 1, gen)

    # -- encrypt / decrypt --------------------------------------------------

    def encrypt(self, pk: PublicKey, pt: Plaintext, gen: torch.Generator) -> Ciphertext:
        return rlwe.encrypt(self.ctx, pk, pt, gen)

    def encrypt_values(self, pk: PublicKey, values, gen: torch.Generator,
                       nlimbs: int | None = None) -> Ciphertext:
        return self.encrypt(pk, self.make_plaintext(values, nlimbs), gen)

    def decrypt(self, sk: SecretKey, ct: Ciphertext, num: int | None = None) -> np.ndarray:
        return rlwe.decrypt(self.ctx, sk, ct, self.encoder, num)

    def _maybe_drop_ext(self, ct: Ciphertext) -> Ciphertext:
        """FLEXIBLEAUTOEXT: drop the extension limb before any mult."""
        if self.params.flexible_ext and ct.nlimbs == self.params.num_q:
            return self.rescale(ct)
        return ct

    # -- homomorphic ops ----------------------------------------------------

    def add(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        return ev.add(self.ctx, ct1, ct2)

    def sub(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        return ev.sub(self.ctx, ct1, ct2)

    def add_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        return ev.add_plain(self.ctx, ct, pt)

    def mult_plain(self, ct: Ciphertext, pt: Plaintext, rescale_after: bool = True) -> Ciphertext:
        out = ev.mult_plain(self.ctx, self._maybe_drop_ext(ct), pt)
        return ev.rescale(self.ctx, out) if rescale_after else out

    def mult_scalar(self, ct: Ciphertext, c: float, rescale_after: bool = True) -> Ciphertext:
        return ev.mult_scalar(self.ctx, self._maybe_drop_ext(ct), c, rescale_after)

    def mult(self, ct1: Ciphertext, ct2: Ciphertext, relin_key: KeySwitchKey,
             rescale_after: bool = True) -> Ciphertext:
        return ev.mult(self.ctx, self._maybe_drop_ext(ct1), self._maybe_drop_ext(ct2),
                       relin_key, rescale_after)

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        return ev.rescale(self.ctx, ct)

    def rotate(self, ct: Ciphertext, r: int, rot_keys) -> Ciphertext:
        """Rotate slots left by r; ``rot_keys`` is a dict by rotation or the
        one key."""
        key = rot_keys[r] if isinstance(rot_keys, dict) else rot_keys
        return ev.rotate(self.ctx, ct, r, key)

    def rotate_hoisted(self, ct: Ciphertext, rotations, rot_keys: dict) -> list:
        return ev.rotate_hoisted(self.ctx, ct, rotations, rot_keys)

    def rotate_sum_hoisted(self, ct: Ciphertext, rotations, rot_keys: dict) -> Ciphertext:
        """Σ_r rotate(ct, r) with one shared decompose+extend and one
        deferred ModDown."""
        return ev.rotate_sum_hoisted(self.ctx, ct, rotations, rot_keys)

    def conjugate(self, ct: Ciphertext, conj_key: KeySwitchKey) -> Ciphertext:
        return ev.conjugate(self.ctx, ct, conj_key)

    def inner_product(self, ct1: Ciphertext, ct2: Ciphertext,
                      relin_key: KeySwitchKey, rot_keys: dict) -> Ciphertext:
        """⟨v1, v2⟩ replicated in every slot: elementwise mult, then a
        rotate-and-add tree over log2(slots) power-of-two rotations."""
        prod = self.mult(ct1, ct2, relin_key)
        r = 1
        while r < self.encoder.slots:
            prod = self.add(prod, self.rotate(prod, r, rot_keys))
            r *= 2
        return prod

    # -- PRE ----------------------------------------------------------------

    def re_encrypt(self, ct: Ciphertext, rekey: KeySwitchKey, pk_to: PublicKey | None = None,
                   gen: torch.Generator | None = None) -> Ciphertext:
        """changeCipherDomain: one key switch of c1, with its d0 added to
        c0. Batched ciphertexts switch in one call. Under PREMode INDCCA the
        output is re-randomized with a fresh Enc_{pk_to}(0) plus uniform
        flooding of 2^pre_flood_bits, one per ciphertext of the batch;
        ``pk_to`` (the TARGET public key) and ``gen`` are then required."""
        indcca = self.params.pre_mode == "INDCCA"
        if indcca and (pk_to is None or gen is None):
            raise ValueError("PREMode INDCCA requires the target public key and a generator "
                             "for re-encryption re-randomization")
        l = ct.nlimbs
        dev = ct.data.device
        q, _, _ = self.ctx.limb_consts(self.ctx.q_idx(l), dev)
        d0, d1 = ev.keyswitch(self.ctx, ct.data[..., 1, :, :], rekey, l)
        out = torch.stack([modadd(ct.data[..., 0, :, :], d0, q), d1], dim=-3)
        if indcca:
            z = rlwe.encrypt_zero(self.ctx, pk_to, l, gen, self.params.pre_flood_bits,
                                  lead=ct.data.shape[:-3], device=dev)
            out = modadd(out, z, q)
        return Ciphertext(data=out, scale=ct.scale)
