"""ctypes bridge to the port's native host core (`csrc/native/`).

The C++ core parses transactions, precomputes their sighash aggregates,
runs the script interpreter (exact, or deferring its curve checks), packs
the verify kernel's lanes and digests the cache keys, each batch in one C
call. It is built with g++ at first use into `build/torch_kernels/`
(`ops/_build.py`); a failed build or load raises `NativeCoreError`, whose
message says how to choose the Python engine instead. Nothing falls back:
the Python engine (`core/`, `crypto/torch_backend.py`'s packers,
`models/sigcache.py`'s `_key`) runs only where a caller passes
`engine="python"`, and stays the executable spec the core is tested
against.

Every pointer argument is declared `c_void_p`: read-only byte inputs go
across as `bytes` objects (ctypes passes their buffer, never null, even
when empty), arrays as the address of a numpy buffer that the caller holds
for the length of the call.

Port of the parts of `bitcoinconsensus_tpu/native_bridge.py` that
`api`, `verify_batch`, the verifier's lane packing and the caches use.
"""

from __future__ import annotations

import ctypes
import itertools
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .ops import _build

__all__ = [
    "ENGINES",
    "NativeCoreError",
    "NativeSecp",
    "NativeSession",
    "NativeTx",
    "digest_checks",
    "digest_streams",
    "lib",
    "prep_pack",
    "use_native",
]

ENGINES = ("native", "python")
NAT_VERSION = 4  # the C ABI these prototypes describe (nat.cpp nat_version)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeCoreError(RuntimeError):
    """The native host core could not be built or loaded."""


def _fail(why: str) -> NativeCoreError:
    return NativeCoreError(
        f"the native host core is unavailable: {why}. Pass engine=\"python\" "
        "(verify_batch, TorchSecpVerifier, the api's verify functions) to run "
        "the Python engine instead"
    )


def lib() -> ctypes.CDLL:
    """The loaded core, built at first use; raises `NativeCoreError`."""
    global _lib
    L = _lib  # set once, never unset: the common path takes no lock
    if L is not None:
        return L
    with _lock:
        if _lib is not None:
            return _lib
        try:
            L = _build.load(_build.HOST_CORE)
        except (RuntimeError, OSError) as e:
            raise _fail(str(e)) from e
        L.nat_version.restype = ctypes.c_int
        L.nat_version.argtypes = []
        if L.nat_version() != NAT_VERSION:
            raise _fail(f"nat_version() is {L.nat_version()}, not {NAT_VERSION}")
        p = ctypes.c_void_p
        i32, i64 = ctypes.c_int32, ctypes.c_int64
        protos = {
            "nat_prep_lanes": ([p, p, p, i32, p, p, p, p, p, p, p], None),
            "nat_verify_ecdsa": ([p, i64, p, i64, p], ctypes.c_int),
            "nat_verify_schnorr": ([p, p, p], ctypes.c_int),
            "nat_tweak_add_check": ([p, i32, p, p], ctypes.c_int),
            "nat_session_new": ([], p),
            "nat_session_free": ([p], None),
            "nat_session_add_known": ([p, i32, i32, p, i64, p, i64, p, i64, i32],
                                      None),
            "nat_session_add_known_batch": ([p, i32, p, p, p, p], None),
            "nat_session_records_count": ([p], i32),
            "nat_session_records_meta": ([p, p, p, p], None),
            "nat_session_records_bytes": ([p], i64),
            "nat_session_records_data": ([p, p], None),
            "nat_session_spec_count": ([p], i32),
            "nat_session_spec_meta": ([p, p, p, p], None),
            "nat_session_spec_bytes": ([p], i64),
            "nat_session_spec_data": ([p, p], None),
            "nat_tx_parse": ([p, i64], p),
            "nat_tx_free": ([p], None),
            "nat_tx_ser_size": ([p], i64),
            "nat_tx_n_inputs": ([p], i32),
            "nat_tx_wtxid": ([p, p], None),
            "nat_tx_set_spent_outputs": ([p, p, p, p, i32], None),
            "nat_tx_precompute": ([p], None),
            "nat_verify_input": ([p, p, i32, i64, p, i64, i32, i32, p, p], i32),
            "nat_verify_inputs": ([p, p, p, p, p, p, p, i32, i32, p, p, p, p],
                                  None),
            "nat_digest_checks": ([p, i64, i32, p, p, p, p], None),
            "nat_digest_streams": ([p, i64, i32, p, p, p, p], None),
        }
        for name, (argtypes, restype) in protos.items():
            fn = getattr(L, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = L
        return _lib


def use_native(engine: str) -> bool:
    """True for `engine="native"`, once its core is loaded (raises if it
    cannot be); False for `engine="python"`; ValueError otherwise."""
    if engine == "native":
        lib()
        return True
    if engine == "python":
        return False
    raise ValueError(f"engine must be one of {ENGINES}, not {engine!r}")


def _addr(arr: np.ndarray) -> int:
    """The address of a C-contiguous numpy buffer the caller keeps alive."""
    return arr.ctypes.data


def _offsets(parts: Sequence) -> np.ndarray:
    """int64 [0, len(p0), len(p0) + len(p1), ...]: the bounds of `parts`
    joined end to end."""
    return np.fromiter(itertools.accumulate(map(len, parts), initial=0),
                       dtype=np.int64, count=len(parts) + 1)


_KIND_CODE = {"ecdsa": 0, "schnorr": 1, "tweak": 2}
_KIND_NAME = {0: "ecdsa", 1: "schnorr", 2: "tweak"}


def _pack_check_parts(checks: Sequence[Tuple[str, Tuple]]):
    """Flatten (kind, data) pairs into the (kinds, blob, offs) wire shape
    of nat_prep_lanes, nat_session_add_known_batch and nat_digest_checks:
    the record's part order (ecdsa pubkey|sig|msg, schnorr pk32|sig64|msg,
    tweak q32|internal32|tweak32), the tweak's parity in kind bit 8."""
    kinds: List[int] = []
    offs: List[int] = []
    parts: List[bytes] = []
    pos = 0
    for kind, data in checks:
        if kind == "tweak":
            p0, p1, p2 = data[0], data[2], data[3]
            kinds.append(2 | ((int(data[1]) & 1) << 8))
        else:
            p0, p1, p2 = data
            kinds.append(_KIND_CODE[kind])
        e0 = pos + len(p0)
        e1 = e0 + len(p1)
        offs += (pos, e0, e1)
        pos = e1 + len(p2)
        parts += (p0, p1, p2)
    offs.append(pos)
    return (np.array(kinds, dtype=np.int32), b"".join(parts),
            np.array(offs, dtype=np.int64))


def prep_pack(checks: Sequence, size: int):
    """The native `_pack_lanes(_prep_lanes(checks))`: the padded 7-tuple of
    numpy arrays `verify_tiles` takes (fields (size, 4, 32) uint8, int32
    want_odd, parity, has_t2, neg1, neg2, bool valid), byte-equal to the
    Python packers'. `checks` are SigCheck-shaped; `size >= len(checks)`."""
    L = lib()
    n = len(checks)
    if size < n:
        raise ValueError(f"size {size} < {n} checks")
    fields = np.zeros((size, 4, 32), dtype=np.uint8)
    want_odd = np.zeros(size, dtype=np.int32)
    parity = np.full(size, -1, dtype=np.int32)
    has_t2 = np.zeros(size, dtype=np.int32)
    neg1 = np.zeros(size, dtype=np.int32)
    neg2 = np.zeros(size, dtype=np.int32)
    valid_i = np.zeros(size, dtype=np.int32)
    if n:
        # nat_prep_lanes takes the tweak's parts as internal|tweak|tweaked
        # (its lane fields' order), not the record's tweaked|internal|tweak.
        kinds, blob, offs = _pack_check_parts(
            [(c.kind, (c.data[2], c.data[1], c.data[3], c.data[0]))
             if c.kind == "tweak" else (c.kind, c.data) for c in checks])
        L.nat_prep_lanes(blob, _addr(offs), _addr(kinds), n, _addr(fields),
                         _addr(want_odd), _addr(parity), _addr(has_t2),
                         _addr(neg1), _addr(neg2), _addr(valid_i))
    return fields, want_odd, parity, has_t2, neg1, neg2, valid_i != 0


def _split32(out: np.ndarray, n: int) -> List[bytes]:
    raw = out.tobytes()
    return [raw[32 * i: 32 * i + 32] for i in range(n)]


def digest_checks(salt: bytes, checks: Sequence[Tuple[str, Tuple]]) -> List[bytes]:
    """Salted cache keys of (kind, data) checks in one C call, byte-equal
    to `SigCache._key(SigCache._parts(kind, data))`."""
    n = len(checks)
    if n == 0:
        return []
    kinds, blob, offs = _pack_check_parts(checks)
    out = np.zeros(32 * n, dtype=np.uint8)
    lib().nat_digest_checks(salt, len(salt), n, _addr(kinds), blob,
                            _addr(offs), _addr(out))
    return _split32(out, n)


def digest_streams(salt: bytes, items: Sequence[Tuple[bytes, ...]]) -> List[bytes]:
    """Salted digests of part lists in one C call, byte-equal to
    `_SaltedLRU._key(parts)` for each item."""
    n = len(items)
    if n == 0:
        return []
    bounds = _offsets(items)  # each item's first and last part
    parts = [p for it in items for p in it]
    offs = _offsets(parts)
    out = np.zeros(32 * n, dtype=np.uint8)
    lib().nat_digest_streams(salt, len(salt), n, _addr(bounds), _addr(offs),
                             b"".join(parts), _addr(out))
    return _split32(out, n)


class NativeTx:
    """A parsed transaction on the C++ side, with its transport fields and,
    after `precompute` or `set_spent_outputs`, its sighash aggregates."""

    __slots__ = ("_ptr", "n_inputs", "ser_size", "_wtxid")

    def __init__(self, raw: bytes):
        L = lib()
        self._ptr = None
        ptr = L.nat_tx_parse(raw, len(raw))
        if not ptr:
            raise ValueError("tx deserialize failed")
        self._ptr = ptr
        self.n_inputs = int(L.nat_tx_n_inputs(ptr))
        self.ser_size = int(L.nat_tx_ser_size(ptr))
        self._wtxid: Optional[bytes] = None

    @property
    def wtxid(self) -> bytes:
        if self._wtxid is None:
            out = ctypes.create_string_buffer(32)
            lib().nat_tx_wtxid(self._ptr, out)
            self._wtxid = out.raw
        return self._wtxid

    def __del__(self):
        # `_lib` is set whenever a handle exists; None at interpreter exit.
        if _lib is not None and getattr(self, "_ptr", None):
            _lib.nat_tx_free(self._ptr)
            self._ptr = None

    def set_spent_outputs(self, spent: Sequence[Tuple[int, bytes]]) -> None:
        """Supply every prevout (amount, scriptPubKey), one per input, and
        precompute the aggregates with them (taproot's sighash needs them)."""
        amounts = np.array([a for a, _ in spent], dtype=np.int64)
        spks = [spk for _, spk in spent]
        offs = _offsets(spks)
        lib().nat_tx_set_spent_outputs(self._ptr, _addr(amounts), b"".join(spks),
                                       _addr(offs), len(spent))

    def precompute(self) -> None:
        lib().nat_tx_precompute(self._ptr)


class NativeSession:
    """One deferral session: the oracle of known check results, the check
    records of the last verify call, and the speculative CHECKMULTISIG
    pairings not yet drained."""

    __slots__ = ("_ptr",)

    MODE_DEFER = 0  # unknown curve checks are recorded and answered true
    MODE_EXACT = 1  # every curve check runs on the host

    def __init__(self):
        self._ptr = lib().nat_session_new()

    def __del__(self):
        if _lib is not None and getattr(self, "_ptr", None):
            _lib.nat_session_free(self._ptr)
            self._ptr = None

    def add_known(self, kind: str, data: Tuple, result: bool) -> None:
        """Publish one resolved check into the oracle."""
        if kind == "tweak":
            p0, parity, p1, p2 = data[0], int(data[1]), data[2], data[3]
        else:
            (p0, p1, p2), parity = data, 0
        lib().nat_session_add_known(self._ptr, _KIND_CODE[kind], parity & 1,
                                    p0, len(p0), p1, len(p1), p2, len(p2),
                                    1 if result else 0)

    def add_known_batch(self, entries: Sequence[Tuple[str, Tuple, bool]]) -> None:
        """Publish many resolved (kind, data, result) checks in one C call."""
        n = len(entries)
        if n == 0:
            return
        kinds, blob, offs = _pack_check_parts([(k, d) for k, d, _ in entries])
        results = np.array([1 if r else 0 for _, _, r in entries], dtype=np.int32)
        lib().nat_session_add_known_batch(self._ptr, n, _addr(kinds), blob,
                                          _addr(offs), _addr(results))

    def _drain(self, count_fn, meta_fn, bytes_fn, data_fn) -> List[Tuple[str, Tuple]]:
        n = int(count_fn(self._ptr))
        if n == 0:
            return []
        kinds = np.zeros(n, dtype=np.int32)
        parities = np.zeros(n, dtype=np.int32)
        lens = np.zeros(3 * n, dtype=np.int64)
        meta_fn(self._ptr, _addr(kinds), _addr(parities), _addr(lens))
        blob = ctypes.create_string_buffer(max(int(bytes_fn(self._ptr)), 1))
        data_fn(self._ptr, blob)
        raw = blob.raw
        kinds_l, parities_l, lens_l = kinds.tolist(), parities.tolist(), lens.tolist()
        out: List[Tuple[str, Tuple]] = []
        pos = 0
        for i in range(n):
            e0 = pos + lens_l[3 * i]
            e1 = e0 + lens_l[3 * i + 1]
            e2 = e1 + lens_l[3 * i + 2]
            kind = _KIND_NAME[kinds_l[i]]
            if kind == "tweak":
                out.append((kind, (raw[pos:e0], parities_l[i], raw[e0:e1], raw[e1:e2])))
            else:
                out.append((kind, (raw[pos:e0], raw[e0:e1], raw[e1:e2])))
            pos = e2
        return out

    def take_records(self) -> List[Tuple[str, Tuple]]:
        """The checks recorded by the last verify call, as (kind, data)
        pairs shaped exactly like `SigCheck.data`."""
        L = lib()
        return self._drain(L.nat_session_records_count,
                           L.nat_session_records_meta,
                           L.nat_session_records_bytes,
                           L.nat_session_records_data)

    def take_spec(self) -> List[Tuple[str, Tuple]]:
        """Drain the speculative CHECKMULTISIG pairings that deferring
        verifies accumulated; a pairing once drained is never emitted again
        by this session."""
        L = lib()
        return self._drain(L.nat_session_spec_count, L.nat_session_spec_meta,
                           L.nat_session_spec_bytes, L.nat_session_spec_data)

    def verify_inputs(
        self,
        ntxs: Sequence[NativeTx],
        n_ins: Sequence[int],
        amounts: Sequence[int],
        script_pubkeys: Sequence[bytes],
        flags: Sequence[int],
        mode: int = MODE_DEFER,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[List[Tuple[str, Tuple]]]]:
        """Verify many inputs in one C call: (ok, script error, unknown
        count) int32 arrays and each input's recorded checks. Speculative
        pairings accumulate on the session (`take_spec`)."""
        n = len(ntxs)
        if not n == len(n_ins) == len(amounts) == len(script_pubkeys) == len(flags):
            raise ValueError("verify_inputs: argument lengths differ")
        if n == 0:
            z = np.zeros(0, np.int32)
            return z, z, z, []
        tx_ptrs = np.array([t._ptr for t in ntxs], dtype=np.uintp)
        nin_a = np.array(n_ins, dtype=np.int32)
        amt_a = np.array(amounts, dtype=np.int64)
        flg_a = np.array(flags, dtype=np.int32)
        spk_offs = _offsets(script_pubkeys)
        ok = np.zeros(n, dtype=np.int32)
        err = np.zeros(n, dtype=np.int32)
        unk = np.zeros(n, dtype=np.int32)
        bounds = np.zeros(n + 1, dtype=np.int64)
        lib().nat_verify_inputs(self._ptr, _addr(tx_ptrs), _addr(nin_a),
                                _addr(amt_a), b"".join(script_pubkeys),
                                _addr(spk_offs), _addr(flg_a), mode, n,
                                _addr(ok), _addr(err), _addr(unk), _addr(bounds))
        flat = self.take_records()
        b = bounds.tolist()
        return ok, err, unk, [flat[b[i]: b[i + 1]] for i in range(n)]

    def verify_input(
        self,
        ntx: NativeTx,
        n_in: int,
        amount: int,
        script_pubkey: bytes,
        flags: int,
        mode: int = MODE_DEFER,
    ) -> Tuple[bool, int, int]:
        """One input: (ok, script error code, unknown count); its records
        wait in `take_records`."""
        serr = ctypes.c_int32()
        unk = ctypes.c_int32()
        ok = lib().nat_verify_input(self._ptr, ntx._ptr, n_in, amount,
                                    script_pubkey, len(script_pubkey), flags,
                                    mode, ctypes.byref(serr), ctypes.byref(unk))
        return bool(ok), serr.value, unk.value


class NativeSecp:
    """The core's exact single-check verifies: the native counterparts of
    `secp_host.verify_ecdsa`, `verify_schnorr` and
    `xonly_tweak_add_check`."""

    @staticmethod
    def verify_ecdsa(pubkey: bytes, sig_der: bytes, msg32: bytes) -> bool:
        if len(msg32) != 32:
            raise ValueError("msg32 must be 32 bytes")
        return bool(lib().nat_verify_ecdsa(pubkey, len(pubkey), sig_der,
                                           len(sig_der), msg32))

    @staticmethod
    def verify_schnorr(pubkey32: bytes, sig64: bytes, msg32: bytes) -> bool:
        if len(pubkey32) != 32 or len(sig64) != 64 or len(msg32) != 32:
            return False
        return bool(lib().nat_verify_schnorr(pubkey32, sig64, msg32))

    @staticmethod
    def tweak_add_check(tweaked32: bytes, parity: int, internal32: bytes,
                        tweak32: bytes) -> bool:
        if len(tweaked32) != 32 or len(internal32) != 32 or len(tweak32) != 32:
            return False
        return bool(lib().nat_tweak_add_check(tweaked32, parity & 1, internal32,
                                              tweak32))
