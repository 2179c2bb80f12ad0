"""A copy of the JAX-free :mod:`ppqsflhe_tpu.ckks.openfhe_emit` (its
package's ``__init__`` imports JAX); tests/test_torch_openfhe.py holds its
bytes to the JAX module's.

OpenFHE cereal emitters: write PublicKey / EvalKey (PRE) / Ciphertext /
CryptoContext artifacts in the reference's wire formats.

The reference serializes keys as cereal-JSON (keyGen.cpp:41-48,
REkeyGen.cpp:60) and ciphertexts as Base64(cereal-BINARY)
(encryptModelWeights.cpp:85-86). openfhe_io.py READS those formats; this
module WRITES them, so a real OpenFHE peer can consume this framework's
artifacts (the reverse interop direction).

Conventions reverse-engineered from the checked-in ground truth
(client_1-private.key, server/storage/CC.json) and verified by
tests/test_interop.py:

- shared_ptr graph: "ptr_wrapper" ids are allocated in document (DFS)
  order starting at 1; the first occurrence carries the MSB flag
  (0x80000000 | id) plus "data", later references carry the bare id.
- polymorphic pointers: first use of a registered type emits
  0x80000000 | registry_id plus "polymorphic_name"
  (e.g. "lbcrypto::CryptoParametersCKKSRNS"); later uses emit the bare
  registry id. Non-polymorphic pointers emit the constant 0x40000000.
  Null pointers emit polymorphic_id 0.
- unique_ptr members (PolyImpl.m_values) serialize as
  {"valid": 1, "data": ...} with no id.
- "cereal_class_version" is emitted once per C++ type per archive (first
  instance only) — the builders place Ver nodes to match.
- multiprecision integers (ubint): little-endian 64-bit words + "m" = MSB.
- cereal-BINARY mirrors the JSON node stream with names dropped:
  u64 size tags, u32 ids/versions/enums, u64 NativeIntegers, raw LE PODs,
  u8 unique_ptr validity, strings as size+bytes.

The emitters are validated two ways (tests/test_interop.py): the generic
re-emitter reproduces the checked-in private key byte-for-byte
(reemit(load(x)) == x — ground-truth proof of the id/version/name engine),
and every synthetic artifact round-trips through this package's readers
bit-equal. Byte-validation against a live OpenFHE build is impossible in
this environment (no OpenFHE, no egress); the field maps for
PublicKeyImpl ("h"), EvalKeyRelinImpl ("k"/"b"-less layout) and
CiphertextImpl ("v","d","l","s","si","sl","t","m") follow OpenFHE 1.x
key-ser/ciphertext-ser declarations and are documented here for audit.
"""

from __future__ import annotations

import json
import struct
import uuid
from typing import List, Optional

import numpy as np

NONPOLY = 0x40000000
MSB = 0x80000000


# ---------------------------------------------------------------------------
# Typed tree nodes
# ---------------------------------------------------------------------------

class Ver:
    """cereal_class_version (u32, once per type per archive)."""

    def __init__(self, v: int):
        self.v = int(v)


class U8:
    def __init__(self, v: int):
        self.v = int(v)


class U32:
    def __init__(self, v: int):
        self.v = int(v)


class U64:
    def __init__(self, v: int):
        self.v = int(v)


class F64:
    def __init__(self, v: float):
        self.v = float(v)


class Str:
    def __init__(self, v: str):
        self.v = str(v)


class Obj:
    """Ordered named fields. Ver nodes render inline as
    "cereal_class_version"."""

    def __init__(self, fields):
        self.fields = list(fields)


class Vec:
    """Size-prefixed sequence (JSON array)."""

    def __init__(self, items, elem_width: Optional[str] = None):
        self.items = list(items)
        self.elem_width = elem_width  # 'u64' → raw int list in JSON


class SPtr:
    """shared_ptr. key: dedupe identity (None → always fresh).
    poly_name: registered polymorphic type name (None → non-polymorphic).
    node None + key None → null pointer."""

    def __init__(self, key, node, poly_name: Optional[str] = None):
        self.key = key
        self.node = node
        self.poly_name = poly_name


class UPtr:
    def __init__(self, node):
        self.node = node


# ---------------------------------------------------------------------------
# Emitters
# ---------------------------------------------------------------------------

class _Alloc:
    def __init__(self):
        self.ids = {}
        self.next_id = 1
        self.poly = {}
        self.next_poly = 1

    def ptr_id(self, key):
        """(id, first_time)"""
        if key is None:
            i = self.next_id
            self.next_id += 1
            return i, True
        if key in self.ids:
            return self.ids[key], False
        i = self.ids[key] = self.next_id
        self.next_id += 1
        return i, True

    def poly_id(self, name):
        if name in self.poly:
            return self.poly[name], False
        i = self.poly[name] = self.next_poly
        self.next_poly += 1
        return i, True


def to_json(node, alloc: Optional[_Alloc] = None):
    """Typed tree → cereal-JSON-compatible python structure."""
    a = alloc or _Alloc()
    if isinstance(node, Ver):
        return node.v
    if isinstance(node, (U8, U32, U64)):
        return node.v
    if isinstance(node, F64):
        return node.v
    if isinstance(node, Str):
        return node.v
    if isinstance(node, Obj):
        out = {}
        for name, f in node.fields:
            out["cereal_class_version" if isinstance(f, Ver) else name] = \
                to_json(f, a)
        return out
    if isinstance(node, Vec):
        return [to_json(x, a) for x in node.items]
    if isinstance(node, SPtr):
        if node.node is None and node.key is None:
            return {"polymorphic_id": 0}
        out = {}
        if node.poly_name is None:
            out["polymorphic_id"] = NONPOLY
        else:
            pid, first = a.poly_id(node.poly_name)
            if first:
                out["polymorphic_id"] = MSB | pid
                out["polymorphic_name"] = node.poly_name
            else:
                out["polymorphic_id"] = pid
        i, first = a.ptr_id(node.key)
        if first:
            out["ptr_wrapper"] = {"id": MSB | i, "data": to_json(node.node, a)}
        else:
            out["ptr_wrapper"] = {"id": i}
        return out
    if isinstance(node, UPtr):
        return {"polymorphic_id": NONPOLY,
                "ptr_wrapper": {"valid": 1, "data": to_json(node.node, a)}}
    raise TypeError(f"unknown node {type(node)}")


def to_binary(node, alloc: Optional[_Alloc] = None) -> bytes:
    """Typed tree → cereal BinaryOutputArchive bytes (little-endian, names
    dropped, u64 size tags)."""
    a = alloc or _Alloc()
    out = bytearray()

    def emit(n):
        if isinstance(n, Ver):
            out.extend(struct.pack("<I", n.v))
        elif isinstance(n, U8):
            out.extend(struct.pack("<B", n.v))
        elif isinstance(n, U32):
            out.extend(struct.pack("<I", n.v))
        elif isinstance(n, U64):
            out.extend(struct.pack("<Q", n.v))
        elif isinstance(n, F64):
            out.extend(struct.pack("<d", n.v))
        elif isinstance(n, Str):
            b = n.v.encode()
            out.extend(struct.pack("<Q", len(b)))
            out.extend(b)
        elif isinstance(n, Obj):
            for _, f in n.fields:
                emit(f)
        elif isinstance(n, Vec):
            out.extend(struct.pack("<Q", len(n.items)))
            if n.elem_width == "u64":
                out.extend(np.asarray([x.v for x in n.items],
                                      dtype="<u8").tobytes())
            else:
                for x in n.items:
                    emit(x)
        elif isinstance(n, SPtr):
            if n.node is None and n.key is None:
                out.extend(struct.pack("<I", 0))
                return
            if n.poly_name is None:
                out.extend(struct.pack("<I", NONPOLY))
            else:
                pid, first = a.poly_id(n.poly_name)
                if first:
                    out.extend(struct.pack("<I", MSB | pid))
                    emit(Str(n.poly_name))
                else:
                    out.extend(struct.pack("<I", pid))
            i, first = a.ptr_id(n.key)
            if first:
                out.extend(struct.pack("<I", MSB | i))
                emit(n.node)
            else:
                out.extend(struct.pack("<I", i))
        elif isinstance(n, UPtr):
            out.extend(struct.pack("<I", NONPOLY))
            out.extend(struct.pack("<B", 1))
            emit(n.node)
        else:
            raise TypeError(f"unknown node {type(n)}")

    emit(node)
    return bytes(out)


# ---------------------------------------------------------------------------
# Generic re-emitter: parsed cereal-JSON → typed tree (ids renormalized).
# Ground-truth test: reemit(load(client_1-private.key)) == the file.
# ---------------------------------------------------------------------------

def tree_from_parsed(doc, poly_names: Optional[dict] = None,
                     seen: Optional[dict] = None):
    """Rebuild a typed tree from a parsed cereal-JSON structure. Pointer
    identities follow the source ids; polymorphic names are propagated from
    their first occurrence. Integer leaves become U64 (width only matters
    for binary, which the generic path does not target)."""
    poly_names = {} if poly_names is None else poly_names
    seen = {} if seen is None else seen

    def walk(n):
        if isinstance(n, dict):
            if "polymorphic_id" in n:
                pid = n["polymorphic_id"]
                if pid == 0:
                    return SPtr(None, None)
                name = None
                if "polymorphic_name" in n:
                    name = n["polymorphic_name"]
                    poly_names[pid & ~MSB] = name
                elif pid != NONPOLY:
                    name = poly_names.get(pid & ~MSB)
                pw = n["ptr_wrapper"]
                if "valid" in pw:
                    return UPtr(walk(pw["data"]))
                src_id = pw["id"] & ~MSB
                if "data" in pw:
                    node = walk(pw["data"])
                    seen[src_id] = True
                    return SPtr(("src", src_id), node, poly_name=name)
                return SPtr(("src", src_id), None, poly_name=name)
            fields = []
            for k, v in n.items():
                if k == "cereal_class_version":
                    fields.append((k, Ver(v)))
                else:
                    fields.append((k, walk(v)))
            return Obj(fields)
        if isinstance(n, list):
            return Vec([walk(x) for x in n])
        if isinstance(n, bool):
            return U8(int(n))
        if isinstance(n, int):
            return U64(n)
        if isinstance(n, float):
            return F64(n)
        if isinstance(n, str):
            return Str(n)
        raise TypeError(f"unexpected leaf {type(n)}")

    return walk(doc)


def reemit_json(parsed_doc) -> dict:
    """Parse → typed tree → fresh cereal-JSON (normalized ids)."""
    return to_json(tree_from_parsed(parsed_doc))


# ---------------------------------------------------------------------------
# OpenFHE node builders (synthetic, template-free)
# ---------------------------------------------------------------------------

def _native(v: int, ver: bool = False):
    f = [("v", U64(int(v)))]
    if ver:
        f.insert(0, ("ccv", Ver(1)))
    return Obj(f)


def _bigint(v: int, ver: bool = False):
    words = []
    x = int(v)
    while True:
        words.append(U64(x & ((1 << 64) - 1)))
        x >>= 64
        if not x:
            break
    f = [("v", Vec(words, elem_width="u64")), ("m", U32(int(v).bit_length()))]
    if ver:
        f.insert(0, ("ccv", Ver(1)))
    return Obj(f)


def _ilnative_params(co: int, rd: int, q: int, ru: int, first: bool):
    """ILNativeParams (one tower's parameter object)."""
    inner = [("co", U32(co)), ("rd", U32(rd)),
             ("cm", _native(q, ver=first)), ("ru", _native(ru)),
             ("bm", _native(0)), ("br", _native(0))]
    if first:
        inner.insert(0, ("ccv", Ver(1)))
    f = [("value0", Obj(inner))]
    if first:
        f.insert(0, ("ccv", Ver(1)))
    return Obj(f)


def _ildcrt_params(co: int, rd: int, moduli, roots, first_elem: bool,
                   tower_keys: List):
    """ILDCRTParams: big-Q ElemParams base + list of tower param POINTERS
    (tower_keys gives the shared identities so towers dedupe)."""
    Q = 1
    for q in moduli:
        Q *= int(q)
    base = [("co", U32(co)), ("rd", U32(rd)),
            ("cm", _bigint(Q, ver=first_elem)), ("ru", _bigint(0)),
            ("bm", _bigint(0)), ("br", _bigint(0))]
    if first_elem:
        base.insert(0, ("ccv", Ver(1)))
    ptrs = []
    for i, (q, r) in enumerate(zip(moduli, roots)):
        ptrs.append(SPtr(tower_keys[i],
                         _ilnative_params(co, rd, int(q), int(r),
                                          first=(first_elem and i == 0))))
    f = [("value0", Obj(base)), ("p", Vec(ptrs))]
    if first_elem:
        f.insert(0, ("ccv", Ver(1)))
    return Obj(f)


def _tower(residues, q: int, ru: int, fmt: int, co: int, rd: int,
           param_key, first: bool, first_params: bool):
    """PolyImpl: unique_ptr NativeVector + format + ILNativeParams ptr."""
    vec = [("v", Vec([U64(int(x)) for x in residues], elem_width="u64")),
           ("m", _native(q))]
    if first:
        vec.insert(0, ("ccv", Ver(1)))
    f = [("v", UPtr(Obj(vec))), ("f", U32(fmt)),
         ("p", SPtr(param_key, _ilnative_params(co, rd, q, ru,
                                                first=first_params)))]
    if first:
        f.insert(0, ("ccv", Ver(1)))
    return Obj(f)


class OpenFheEmitter:
    """Emits key/ciphertext/context artifacts for ONE parameter chain.

    ``moduli``/``roots``: the full basis the emitted DCRTPolys live over
    (Q for ciphertexts, QP for key-switch keys). ``cc_params`` optionally
    carries the scalar context fields (scheme/encoding parameters) used by
    the synthetic CryptoContext subtree.
    """

    def __init__(self, ring_dim: int, moduli, roots, batch_size: int = 0,
                 scaling_mod_size: int = 40, mult_depth: int = 2,
                 dnum: int = 2, sigma: float = 3.19):
        self.rd = int(ring_dim)
        self.co = 2 * self.rd
        self.moduli = [int(q) for q in moduli]
        self.roots = [int(r) for r in roots]
        self.batch = int(batch_size) or self.rd // 2
        self.smod = scaling_mod_size
        self.muld = mult_depth
        self.dnum = dnum
        self.sigma = sigma

    # -- sub-builders -------------------------------------------------------

    def _tower_keys(self, tag: str):
        return [(tag, "tower_params", i) for i in range(len(self.moduli))]

    def _dcrt(self, towers: np.ndarray, fmt: int, tag: str,
              versions_fresh: bool, moduli=None, roots=None):
        """DCRTPoly node. versions_fresh=True → this poly carries the
        first-instance class versions for DCRTPoly/PolyImpl/NativeVector.
        Parameter-type versions (ILNativeParams/ILDCRTParams/ints) are
        NEVER fresh here: every emitted artifact embeds the CryptoContext
        first, which consumes them (ground truth: client_1-private.key's
        tower "p" nodes carry no cereal_class_version)."""
        moduli = moduli if moduli is not None else self.moduli
        roots = roots if roots is not None else self.roots
        tkeys = self._tower_keys(tag)[: towers.shape[0]]
        items = []
        for i in range(towers.shape[0]):
            items.append(_tower(
                towers[i], moduli[i], roots[i], fmt, self.co, self.rd,
                tkeys[i], first=(versions_fresh and i == 0),
                first_params=False))
        f = [("v", Vec(items)), ("f", U32(fmt)),
             ("p", SPtr((tag, "dcrt_params", towers.shape[0]),
                        _ildcrt_params(self.co, self.rd,
                                       moduli[: towers.shape[0]],
                                       roots[: towers.shape[0]],
                                       first_elem=False, tower_keys=tkeys)))]
        if versions_fresh:
            f.insert(0, ("ccv", Ver(1)))
        return Obj(f)

    def _scheme(self):
        inner = Obj([("ccv", Ver(0)),
                     ("value0", Obj([("ccv", Ver(0)),
                                     ("value0", Obj([
                                         ("ccv", Ver(0)),
                                         ("fhe", SPtr(None, None)),
                                         ("schswitch", SPtr(None, None)),
                                         ("enabled", U32(63)),
                                     ]))]))])
        return SPtr(("scheme",), inner, poly_name="lbcrypto::SchemeCKKSRNS")

    def _crypto_params(self):
        """CryptoParametersCKKSRNS subtree (synthetic; scalar fields mirror
        the reference genCC configuration, CC.json ground truth)."""
        L = self.muld + 1
        elp = SPtr(("elp",),
                   _ildcrt_params(self.co, self.rd, self.moduli[:L],
                                  self.roots[:L], first_elem=True,
                                  tower_keys=self._tower_keys("cc")[:L]))
        enp = SPtr(("enp",), Obj([
            ("ccv", Ver(1)), ("m", U64(self.smod)), ("ru", _native(0)),
            ("bm", _native(0)), ("bru", _native(0)), ("g", U32(0)),
            ("bs", U32(self.batch)),
        ]))
        base = Obj([("ccv", Ver(0)), ("elp", elp), ("enp", enp)])
        rlwe = Obj([
            ("ccv", Ver(0)), ("value0", base),
            ("dp", F64(self.sigma)), ("am", F64(36.0)), ("ns", U32(1)),
            ("rw", U32(0)), ("nest", F64(0.0)), ("muld", U32(self.muld)),
            ("addc", U32(0)), ("kswc", U32(0)), ("phops", U32(0)),
            ("md", U32(2)), ("mo", U32(1)), ("pmo", U32(1)), ("mmo", U32(1)),
            ("exm", U32(0)), ("dnm", U32(0)), ("slv", U32(0)),
            ("fdp", F64(0.0)), ("ss", F64(30.0)), ("aq", F64(1.0)),
            ("tp", U32(1)),
        ])
        rns = Obj([
            ("ccv", Ver(0)), ("value0", rlwe),
            ("ks", U32(2)), ("rs", U32(3)), ("encs", U32(0)), ("muls", U32(1)),
            ("dnum", U32(self.dnum)), ("ab", U32(60)), ("eb", U32(20)),
            ("ccl", U32(3)), ("cd", U32(1)), ("rws", U32(64)), ("cdt", U32(0)),
        ])
        ckks = Obj([("ccv", Ver(0)), ("value0", rns)])
        return SPtr(("cparams",), ckks,
                    poly_name="lbcrypto::CryptoParametersCKKSRNS")

    def cc_tree(self, top_version: int = 0):
        """CryptoContextImpl data node (version 0 standalone, 1 embedded —
        both observed in the ground-truth artifacts)."""
        return Obj([("ccv", Ver(top_version)),
                    ("cc", self._crypto_params()),
                    ("kt", self._scheme()),
                    ("si", U32(1))])

    def _key_base(self, key_tag: str):
        """Key<Element> → CryptoObject base (cc pointer + key tag)."""
        cc = SPtr(("cc",), self.cc_tree(top_version=1))
        return Obj([("ccv", Ver(0)),
                    ("value0", Obj([("ccv", Ver(0)), ("cc", cc),
                                    ("kt", Str(key_tag))]))])

    # -- public artifact builders -------------------------------------------

    def public_key_doc(self, pk_towers: np.ndarray, key_tag: str | None = None):
        """PublicKeyImpl cereal-JSON (keyGen.cpp:45 twin): Key base + "h"
        vector of the two EVAL-format DCRTPolys (b, a)."""
        key_tag = key_tag or uuid.uuid4().hex
        body = Obj([
            ("ccv", Ver(0)),
            ("value0", self._key_base(key_tag)),
            ("h", Vec([self._dcrt(pk_towers[0], 0, "pk", versions_fresh=True),
                       self._dcrt(pk_towers[1], 0, "pk", versions_fresh=False)])),
        ])
        return {"value0": to_json(SPtr(("root",), body))}

    def secret_key_doc(self, s_towers: np.ndarray, key_tag: str | None = None):
        """PrivateKeyImpl cereal-JSON (keyGen.cpp:41 twin, "s" member)."""
        key_tag = key_tag or uuid.uuid4().hex
        body = Obj([
            ("ccv", Ver(0)),
            ("value0", self._key_base(key_tag)),
            ("s", self._dcrt(s_towers, 0, "sk", versions_fresh=True)),
        ])
        return {"value0": to_json(SPtr(("root",), body))}

    def eval_key_doc(self, rekey: np.ndarray, key_tag: str | None = None):
        """EvalKeyRelinImpl cereal-JSON (REkeyGen.cpp:60 twin).

        ``rekey``: u64[nd, 2, L+K, N] (this package's KeySwitchKey layout) →
        OpenFHE's m_rKey = [[b_0..b_{nd-1}], [a_0..a_{nd-1}]] ("k" member),
        DCRTPolys over the extended QP basis, EVAL format."""
        key_tag = key_tag or uuid.uuid4().hex
        nd = rekey.shape[0]
        rows = []
        for comp in range(2):
            rows.append(Vec([
                self._dcrt(rekey[j, comp], 0, "ek",
                           versions_fresh=(comp == 0 and j == 0))
                for j in range(nd)]))
        body = Obj([
            ("ccv", Ver(0)),
            ("value0", Obj([("ccv", Ver(0)),
                            ("value0", self._key_base(key_tag))])),
            ("k", Vec(rows)),
        ])
        return {"value0": to_json(SPtr(
            ("root",), body,
            poly_name="lbcrypto::EvalKeyRelinImpl<lbcrypto::DCRTPoly>"))}

    def ciphertext_tree(self, ct_towers: np.ndarray, scale: float,
                        level: int = 0, key_tag: str | None = None,
                        slots: int | None = None, moduli=None, roots=None):
        """CiphertextImpl typed tree (encryptModelWeights.cpp:85 twin).

        ``ct_towers``: u64[2, l, N] EVAL format. Field map (OpenFHE 1.x
        ciphertext-ser): v=elements, d=noiseScaleDeg, l=level,
        s=scalingFactor, si=scalingFactorInt, sl=slots, t=encodingType
        (CKKS_PACKED_ENCODING=1), m=metadata map (empty)."""
        key_tag = key_tag or uuid.uuid4().hex
        elems = Vec([
            self._dcrt(ct_towers[i], 0, "ct", versions_fresh=(i == 0),
                       moduli=moduli, roots=roots)
            for i in range(ct_towers.shape[0])])
        body = Obj([
            ("ccv", Ver(0)),
            ("value0", self._key_base(key_tag)),
            ("v", elems),
            ("d", U32(1)),
            ("l", U32(level)),
            ("s", F64(scale)),
            ("si", _native(1)),
            ("sl", U32(slots if slots is not None else self.batch)),
            ("t", U32(1)),
            ("m", SPtr(("meta",), Vec([]))),
        ])
        return SPtr(("root",), body)

    def ciphertext_binary(self, ct_towers: np.ndarray, scale: float,
                          level: int = 0, key_tag: str | None = None,
                          slots: int | None = None, moduli=None,
                          roots=None) -> bytes:
        """cereal-BINARY ciphertext bytes (Base64-wrap for the wire)."""
        return to_binary(self.ciphertext_tree(
            ct_towers, scale, level, key_tag, slots, moduli, roots))


# ---------------------------------------------------------------------------
# Binary reader (round-trip verification of ciphertext_binary)
# ---------------------------------------------------------------------------

class _Cursor:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def take(self, fmt: str):
        v = struct.unpack_from("<" + fmt, self.buf, self.off)[0]
        self.off += struct.calcsize(fmt)
        return v

    def u8(self):
        return self.take("B")

    def u32(self):
        return self.take("I")

    def u64(self):
        return self.take("Q")

    def f64(self):
        return self.take("d")

    def string(self):
        n = self.u64()
        s = self.buf[self.off : self.off + n].decode()
        self.off += n
        return s

    def u64_array(self, n: int):
        a = np.frombuffer(self.buf, dtype="<u8", count=n, offset=self.off)
        self.off += 8 * n
        return a.copy()


def parse_ciphertext_binary(buf: bytes) -> dict:
    """Parse bytes produced by :meth:`OpenFheEmitter.ciphertext_binary`
    (mirrors the builder layout exactly; validates every structural
    constant). Returns towers/moduli/roots/fmt/scale/level/slots/key_tag."""
    c = _Cursor(buf)
    seen_ptr: dict = {}

    def sptr_header():
        pid = c.u32()
        if pid == 0:
            return None, False
        if pid & MSB:
            c.string()          # polymorphic name (unused by this reader)
        elif pid != NONPOLY:
            pass
        i = c.u32()
        first = bool(i & MSB)
        return i & ~MSB, first

    def native(ver: bool = False):
        if ver:
            assert c.u32() == 1
        return c.u64()

    def bigint(ver: bool = False):
        if ver:
            assert c.u32() == 1
        n = c.u64()
        words = c.u64_array(n)
        msb = c.u32()
        return sum(int(w) << (64 * k) for k, w in enumerate(words)), msb

    def ilnative_params(first: bool):
        if first:
            assert c.u32() == 1    # ccv outer
            assert c.u32() == 1    # ccv inner
        co = c.u32()
        rd = c.u32()
        q = native(ver=first)
        ru = native()
        native()                   # bm
        native()                   # br
        return co, rd, q, ru

    def ildcrt_params(first: bool):
        if first:
            assert c.u32() == 1
            assert c.u32() == 1
        c.u32()                    # co
        c.u32()                    # rd
        bigint(ver=first)          # big Q
        bigint()
        bigint()
        bigint()
        nt = c.u64()
        out = []
        for k in range(nt):
            i, fresh = sptr_header()
            if fresh:
                out.append(ilnative_params(first=(first and k == 0)))
                seen_ptr[i] = out[-1]
            else:
                out.append(seen_ptr[i])
        return out

    def tower(first: bool):
        if first:
            assert c.u32() == 1    # PolyImpl ccv
        assert c.u32() == NONPOLY  # unique_ptr header
        assert c.u8() == 1
        if first:
            assert c.u32() == 1    # NativeVector ccv
        n = c.u64()
        vals = c.u64_array(n)
        q = native()               # vector modulus
        fmt = c.u32()
        i, fresh = sptr_header()
        if fresh:
            # param-type versions were consumed by the embedded cc subtree
            seen_ptr[i] = ilnative_params(first=False)
        _, _, q_p, ru = seen_ptr[i]
        assert q_p == q
        return vals, q, ru, fmt

    def dcrt(first: bool):
        if first:
            assert c.u32() == 1    # DCRTPoly ccv
        nt = c.u64()
        towers, moduli, roots, fmt = [], [], [], 0
        for k in range(nt):
            vals, q, ru, fmt = tower(first=(first and k == 0))
            towers.append(vals)
            moduli.append(q)
            roots.append(ru)
        fmt2 = c.u32()
        i, fresh = sptr_header()
        if fresh:
            seen_ptr[i] = ildcrt_params(first=False)
        return np.stack(towers), moduli, roots, fmt2

    def cc_subtree():
        """Skip the embedded CryptoContext (structure known, content not
        returned)."""
        assert c.u32() == 1        # CryptoContextImpl ccv (embedded = 1)
        i, fresh = sptr_header()   # CryptoParametersCKKSRNS
        assert fresh
        assert c.u32() == 0        # ckks ccv
        assert c.u32() == 0        # rns ccv
        assert c.u32() == 0        # rlwe ccv
        assert c.u32() == 0        # base ccv
        ie, fresh = sptr_header()  # elp
        assert fresh
        seen_ptr[ie] = ildcrt_params(first=True)
        ienp, fresh = sptr_header()
        assert fresh
        assert c.u32() == 1        # EncodingParams ccv
        c.u64()                    # m
        native()                   # ru
        native()                   # bm
        native()                   # bru
        c.u32()                    # g
        bs = c.u32()
        # rlwe scalars: dp am (f64) ns rw (u32) nest (f64) muld..phops (u32×4)
        c.f64(); c.f64(); c.u32(); c.u32(); c.f64()
        for _ in range(4):
            c.u32()
        for _ in range(4):         # md mo pmo mmo
            c.u32()
        for _ in range(3):         # exm dnm slv
            c.u32()
        c.f64(); c.f64(); c.f64()  # fdp ss aq
        c.u32()                    # tp
        for _ in range(4):         # ks rs encs muls
            c.u32()
        c.u32()                    # dnum
        for _ in range(6):         # ab eb ccl cd rws cdt
            c.u32()
        i2, fresh = sptr_header()  # scheme
        assert fresh
        assert c.u32() == 0
        assert c.u32() == 0
        assert c.u32() == 0
        assert c.u32() == 0        # fhe null
        assert c.u32() == 0        # schswitch null
        c.u32()                    # enabled
        c.u32()                    # si
        return bs

    i, fresh = sptr_header()       # root CiphertextImpl
    assert fresh
    assert c.u32() == 0            # CiphertextImpl ccv
    assert c.u32() == 0            # CryptoObject wrapper ccv
    assert c.u32() == 0            # inner ccv
    icc, fresh = sptr_header()     # cc pointer
    assert fresh
    cc_subtree()
    key_tag = c.string()
    n_elems = c.u64()
    elems = []
    meta = {}
    for k in range(n_elems):
        towers, moduli, roots, fmt = dcrt(first=(k == 0))
        elems.append(towers)
        meta = {"moduli": moduli, "roots": roots, "fmt": fmt}
    d = c.u32()
    level = c.u32()
    scale = c.f64()
    si = native()
    slots = c.u32()
    t = c.u32()
    sptr_header()                  # metadata map ptr
    c.u64()                        # empty map size
    assert c.off == len(buf), (c.off, len(buf))
    return {"towers": np.stack(elems), "key_tag": key_tag, "d": d,
            "level": level, "scale": scale, "si": si, "slots": slots,
            "t": t, **meta}
