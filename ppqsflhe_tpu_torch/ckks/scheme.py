"""High-level CKKS facade, the twin of ``ppqsflhe_tpu.ckks.scheme``: encoding
and decoding (fresh full-level plaintexts at Δ·q_ext under FLEXIBLEAUTOEXT,
whose extension limb is dropped before any multiplication), keygen,
rekey_gen, relinearization, rotation and conjugation keys, encrypt_values,
decrypt, add, sub, add_plain, mult_plain, mult_scalar, ct×ct mult,
rescale, rotations (plain, hoisted, rotation sums), conjugation, the packed
inner product, and re_encrypt in both PRE modes. The scheme's ``device`` is
where it creates new tensors: the card unless the caller asks for another
(``device="cpu"`` runs the plain versions). Randomness comes from explicit
``torch.Generator``s.

The JAX scheme jits each operation once per (operation, static
configuration) (``_jit``). Here :meth:`CkksScheme._graph` caches a CUDA
graph per operation, keyed by the JAX key plus the inputs' shapes, dtypes
and devices, every ciphertext's and plaintext's scale and the key's
``mont`` flag: add, sub, add_plain, mult_plain, mult_scalar, mult,
rescale, rotate, conjugate, re_encrypt in both PRE modes, decrypt's device
half (``"decrypt_core"``), and the randomized operations: keygen (without
a seed, as the JAX scheme jits it), relin_key_gen, rot_key_gen per Galois
element, conj_key_gen, rekey_gen, encrypt, and the tools' compositions:
sk-encryption (``("encrypt_sk", l)``), decryptModelWeights' batched
decryption (``("decrypt_batch", l, k)``) and aggregateEncryptedWeights'
sum and ÷N (``("aggregate", …)``). A randomized operation draws
first, outside the cache, one sampler call of each kind over the whole
batch on the caller's generator (``rlwe.*_draws``, ``ev.ksk_draws``); its
draws are inputs of the cached body like the ciphertexts, so a CPU and a
CUDA generator serve alike and no generator is reseeded or moved. A key's
first :data:`WARMUP` calls run the eager body on a side stream, the next
captures it over static input buffers the cache owns (ciphertexts,
plaintexts, keys and draws are copied in, so keys of one shape share a
graph and none is kept alive by one), and every later call copies its
inputs in and replays. Each call returns clones of the graph's outputs, so
no later call changes an earlier result. An operation that reads a secret
key, draws or a plaintext (the randomized ones, ``decrypt_core`` and
``decrypt_batch``) then zeroes its static inputs and outputs, so the
cache keeps no copy of a secret between calls; the graph's pool of
intermediates is, like the allocator's freed blocks on the eager path,
overwritten only by later work. The body runs eagerly on the CPU,
inside :func:`..utils.graphs.eager` (every whole-program warm-up), while
the current stream captures (a whole-program graph then holds the
operation's kernels) and on a context that runs collectives
(``CkksContext.per_op_graphs`` False). On the card a failed capture raises
``RuntimeError`` naming the operation and its key; there is no eager
fallback. The hoisted rotations stay eager, as the JAX scheme leaves them
unjitted.
"""

from __future__ import annotations

import numpy as np
import torch

from . import eval as ev
from . import rlwe
from ..utils import graphs
from ..utils.graphs import WARMUP  # noqa: F401  (the cache's warm-up count, read by callers)
from .encoding import Encoder
from .params import CkksContext, CkksParams
from .types import Ciphertext, KeySwitchKey, Plaintext, PublicKey, SecretKey


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


class CkksScheme:
    def __init__(self, params: CkksParams, device="cuda"):
        self.params = params
        self.device = torch.device(device)
        self.ctx = CkksContext(params)
        self.encoder = Encoder(params.n, params.slots or params.n // 2)
        self._graphs = graphs.GraphCache()

    def _graph(self, key, body, *inputs, scrub: bool = False):
        """``body(*inputs)`` through the per-op graph cache, the
        counterpart of the JAX scheme's ``_jit``: ``key`` is the JAX key
        (the operation and its static configuration); the inputs
        (ciphertexts, plaintexts, key-switch keys, tensors) add their
        signatures. ``scrub`` (an operation that reads a secret key, draws
        or a plaintext) zeroes the graph's static inputs and outputs after
        every call. Eager on the CPU, inside :func:`..utils.graphs.eager`,
        during another capture and on a context that runs collectives."""
        if (not _on_card(graphs.leaf(inputs[0])) or not self.ctx.per_op_graphs
                or graphs.bypass()):
            return body(*inputs)
        return self._graphs.run(key, "the CkksScheme operation", body, inputs, scrub)

    # -- encoding -----------------------------------------------------------

    def make_plaintext(self, values, nlimbs: int | None = None,
                       scale: float | None = None) -> Plaintext:
        """One real vector, or a list of them (→ a batched plaintext), to
        eval-domain residues over the first ``nlimbs`` Q limbs. Under
        FLEXIBLEAUTOEXT a fresh full-level plaintext encodes at Δ·q_ext.
        Encoding and upload on the host; the transform through the
        context's cache under the JAX tools' key ``("api_ntt", l)``,
        scrubbed (it holds a plaintext)."""
        l = nlimbs or self.params.num_q
        if scale is None:
            scale = self.params.scale
            if self.params.flexible_ext and l == self.params.num_q:
                scale *= float(self.params.q_moduli[-1])
        batched = isinstance(values, (list, tuple))
        coeffs = self.encoder.encode_batch(values if batched else [values], scale)
        rns = self.encoder.to_rns_batch(coeffs, self.ctx.moduli_qp[:l])   # (B, l, n)
        data = torch.as_tensor(rns.view(np.int64), device=self.device)
        idx = self.ctx.q_idx(l)
        data = self.ctx.cached(("api_ntt", l), "the encoding transform",
                               lambda x: self.ctx.ntt(x, idx), data if batched else data[0],
                               scrub=True)
        return Plaintext(data=data, scale=scale)

    def decode(self, coeffs_centered, scale: float, num: int | None = None) -> np.ndarray:
        """Centered integer coefficients (host) → real slot values."""
        return self.encoder.decode(coeffs_centered, scale, num).real

    # -- keys ---------------------------------------------------------------

    def keygen(self, gen: torch.Generator,
               a_seed: bytes | None = None) -> tuple[SecretKey, PublicKey]:
        """Ternary secret and public key; with ``a_seed`` the key's ``a``
        expands from the seed and the body runs eagerly, as the JAX scheme
        leaves the seeded keygen unjitted."""
        draws = rlwe.keygen_draws(self.ctx, gen, self.device, a_seed)
        body = lambda s, a, e: rlwe.keygen_body(self.ctx, s, a, e)
        out = (body(*draws) if a_seed is not None
               else self._graph("keygen", body, *draws, scrub=True))
        return rlwe.keys_of(draws[0], *out)

    def _sk_ksk(self, key, target, sk: SecretKey, gen: torch.Generator) -> KeySwitchKey:
        """A key-switch key under ``sk`` keying ``target(s_eval[:L])``
        through the cache under ``key``."""
        draws = ev.ksk_draws(self.ctx, gen, sk.s_eval.device, pk_path=False)
        body = lambda s, a, e: ev.ksk_body(self.ctx, target(s[: self.params.num_q]), s, False,
                                           a, e)
        return self._graph(key, body, sk.s_eval, *draws, scrub=True)

    def rekey_gen(self, sk_from: SecretKey, pk_to: PublicKey,
                  gen: torch.Generator) -> KeySwitchKey:
        """Proxy re-encryption key A→B from A's secret and B's public key
        (INDCPA PRE)."""
        L = self.params.num_q
        draws = ev.ksk_draws(self.ctx, gen, sk_from.s_eval.device, pk_path=True)
        body = lambda s, pk, u, e: ev.ksk_body(self.ctx, s[:L], pk.data, True, u, e)
        return self._graph("rekey_gen", body, sk_from.s_eval, pk_to, *draws, scrub=True)

    def relin_key_gen(self, sk: SecretKey, gen: torch.Generator) -> KeySwitchKey:
        """Key switching s² → s, for relinearizing a ct×ct product."""
        idx = tuple(range(self.params.num_q))
        return self._sk_ksk("relin_key_gen", lambda s: rlwe._poly_mul(self.ctx, s, s, idx),
                            sk, gen)

    def _galois_key(self, key, sk: SecretKey, g: int, gen: torch.Generator) -> KeySwitchKey:
        return self._sk_ksk(key, lambda s: ev.automorphism(self.ctx, s, g), sk, gen)

    def rotation_key_gen(self, sk: SecretKey, rotations, gen: torch.Generator) -> dict:
        """Keys for slot rotations (EvalRotateKeyGen), by rotation."""
        out = {}
        for r in rotations:
            g = ev.rot_to_galois(r, self.params.n)
            out[r] = self._galois_key(("rot_key_gen", g), sk, g, gen)
        return out

    def conjugation_key_gen(self, sk: SecretKey, gen: torch.Generator) -> KeySwitchKey:
        return self._galois_key("conj_key_gen", sk, 2 * self.params.n - 1, gen)

    # -- encrypt / decrypt --------------------------------------------------

    def encrypt(self, pk: PublicKey, pt: Plaintext, gen: torch.Generator) -> Ciphertext:
        return self.encrypt_drawn(pk, pt, rlwe.encrypt_draws(self.ctx, gen, pt.data.shape[:-2],
                                                             pt.data.device))

    def encrypt_drawn(self, pk: PublicKey, pt: Plaintext, draws) -> Ciphertext:
        """:meth:`encrypt`'s body through the cache on the draws of
        ``rlwe.encrypt_draws``."""
        return self._graph("encrypt", lambda p, t, u, e: rlwe.encrypt_body(self.ctx, p, t, u, e),
                           pk, pt, *draws, scrub=True)

    def encrypt_sk(self, sk: SecretKey, pt: Plaintext, gen: torch.Generator,
                   a_seed) -> Ciphertext:
        """``rlwe.encrypt_sk``: its draws (the masks expanded from
        ``a_seed``, one Gaussian draw), then its body through the cache
        under ``("encrypt_sk", l)``, the JAX tools' jitted batch."""
        a, e = rlwe.encrypt_sk_draws(self.ctx, gen, pt, a_seed)
        return self._graph(("encrypt_sk", pt.nlimbs),
                           lambda s, p, a_, e_: rlwe.encrypt_sk_body(self.ctx, s, p, a_, e_),
                           sk.s_eval, pt, a, e, scrub=True)

    def encrypt_values(self, pk: PublicKey, values, gen: torch.Generator,
                       nlimbs: int | None = None) -> Ciphertext:
        return self.encrypt(pk, self.make_plaintext(values, nlimbs), gen)

    def decrypt(self, sk: SecretKey, ct: Ciphertext, num: int | None = None) -> np.ndarray:
        """The device half (``"decrypt_core"``) through the graph cache,
        the decoding on the host."""
        coeffs = self._graph("decrypt_core",
                             lambda s, c: rlwe.decrypt_to_coeffs(self.ctx, s, c), sk.s_eval, ct,
                             scrub=True)
        return rlwe.decode_coeffs(self.ctx, coeffs, ct, self.encoder, num)

    def _maybe_drop_ext(self, ct: Ciphertext) -> Ciphertext:
        """FLEXIBLEAUTOEXT: drop the extension limb before any mult."""
        if self.params.flexible_ext and ct.nlimbs == self.params.num_q:
            return self.rescale(ct)
        return ct

    # -- homomorphic ops ----------------------------------------------------

    def add(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        return self._graph("add", lambda a, b: ev.add(self.ctx, a, b), ct1, ct2)

    def sub(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        return self._graph("sub", lambda a, b: ev.sub(self.ctx, a, b), ct1, ct2)

    def add_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        return self._graph("add_plain", lambda a, p: ev.add_plain(self.ctx, a, p), ct, pt)

    def mult_plain(self, ct: Ciphertext, pt: Plaintext, rescale_after: bool = True) -> Ciphertext:
        def body(a, p):
            out = ev.mult_plain(self.ctx, a, p)
            return ev.rescale(self.ctx, out) if rescale_after else out
        return self._graph(("mult_plain", rescale_after), body, self._maybe_drop_ext(ct), pt)

    def mult_scalar(self, ct: Ciphertext, c: float, rescale_after: bool = True) -> Ciphertext:
        return self._graph(("mult_scalar", float(c), rescale_after),
                           lambda a: ev.mult_scalar(self.ctx, a, c, rescale_after),
                           self._maybe_drop_ext(ct))

    def mult(self, ct1: Ciphertext, ct2: Ciphertext, relin_key: KeySwitchKey,
             rescale_after: bool = True) -> Ciphertext:
        return self._graph(("mult", rescale_after),
                           lambda a, b, rk: ev.mult(self.ctx, a, b, rk, rescale_after),
                           self._maybe_drop_ext(ct1), self._maybe_drop_ext(ct2), relin_key)

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        return self._graph("rescale", lambda a: ev.rescale(self.ctx, a), ct)

    def rotate(self, ct: Ciphertext, r: int, rot_keys) -> Ciphertext:
        """Rotate slots left by r; ``rot_keys`` is a dict by rotation or the
        one key."""
        key = rot_keys[r] if isinstance(rot_keys, dict) else rot_keys
        return self._graph(("rotate", r), lambda a, k: ev.rotate(self.ctx, a, r, k), ct, key)

    def rotate_hoisted(self, ct: Ciphertext, rotations, rot_keys: dict) -> list:
        return ev.rotate_hoisted(self.ctx, ct, rotations, rot_keys)

    def rotate_sum_hoisted(self, ct: Ciphertext, rotations, rot_keys: dict) -> Ciphertext:
        """Σ_r rotate(ct, r) with one shared decompose+extend and one
        deferred ModDown."""
        return ev.rotate_sum_hoisted(self.ctx, ct, rotations, rot_keys)

    def conjugate(self, ct: Ciphertext, conj_key: KeySwitchKey) -> Ciphertext:
        return self._graph("conjugate", lambda a, k: ev.conjugate(self.ctx, a, k), ct, conj_key)

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
        if not indcca:
            return self._graph("re_encrypt", lambda c, k: ev.re_encrypt(self.ctx, c, k), ct,
                               rekey)
        draws = rlwe.zero_draws(self.ctx, gen, ct.data.shape[:-3], ct.data.device,
                                self.params.pre_flood_bits)
        return self._graph(("re_encrypt", "INDCCA"),
                           lambda c, k, pk, *d: ev.re_encrypt_indcca(self.ctx, c, k, pk, *d),
                           ct, rekey, pk_to, *draws, scrub=True)
