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
`api`, `verify_batch`, the verifier's lane packing and the caches use, the
index-mode surface of the batch drivers (`NativeSession.verify_inputs_idx`
and the `uniq_*` calls) and the block layer of `connect_block`
(`NativeBlock`, `NativeCoinsView`).
"""

from __future__ import annotations

import ctypes
import itertools
import threading
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .ops import _build

__all__ = [
    "BLOCK_REASONS",
    "ENGINES",
    "NativeBlock",
    "NativeBlockTx",
    "NativeCoinsView",
    "NativeCoreError",
    "NativeSecp",
    "NativeSession",
    "NativeTx",
    "available",
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
            # the index-mode surface: checks stay in the session's uniq list
            "nat_verify_inputs_idx": ([p, p, p, p, p, p, p, i32, i32, p, p, p, p],
                                      None),
            "nat_session_uniq_count": ([p], i32),
            "nat_session_recidx_data": ([p, p, i64], i64),
            "nat_session_uniq_lanes": ([p, p, i32, p, p, p, p, p, p, p], None),
            "nat_session_uniq_digests": ([p, p, i64, p, i32, p], None),
            "nat_session_publish_uniq": ([p, p, i32, p], None),
            "nat_session_uniq_host_verify": ([p, i32], i32),
            # the block layer (block.hpp) and the coins view
            "nat_block_parse": ([p, i64], p),
            "nat_block_free": ([p], None),
            "nat_block_n_tx": ([p], i32),
            "nat_block_n_inputs": ([p], i32),
            "nat_block_tx": ([p, i32], p),
            "nat_block_txid": ([p, i32, p], None),
            "nat_block_wtxid": ([p, i32, p], None),
            "nat_block_check": ([p, i32, p, i32], i32),
            "nat_block_check_witness": ([p], i32),
            "nat_block_accounting": ([p, p, i64, i32], i32),
            "nat_block_acct_meta": ([p, p, p, p, p], None),
            "nat_block_acct_data": ([p, p, p, p, p, p], None),
            "nat_block_spent_digests": ([p, p], None),
            "nat_block_script_keys": ([p, p, i64, i32, p], None),
            "nat_view_new": ([], p),
            "nat_view_free": ([p], None),
            "nat_view_clone": ([p], p),
            "nat_view_len": ([p], i64),
            "nat_view_add_coins": ([p, i32, p, p, p, p, p, p, p], None),
            "nat_view_get": ([p, p, i32, p, p, p, p], i32),
            "nat_view_get_spk": ([p, p, i32, p], None),
            "nat_view_spend": ([p, p, i32], i32),
            "nat_view_apply_block": ([p, p, i64], None),
        }
        for name, (argtypes, restype) in protos.items():
            fn = getattr(L, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = L
        return _lib


def available() -> bool:
    """Whether the native host core builds and loads (building it at the
    first call). A query only: nothing changes engine on its answer, and
    `engine="native"` still raises where it is False."""
    try:
        lib()
    except NativeCoreError:
        return False
    return True


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

    # -- index mode: the deduplicated checks stay in the session's `uniq`
    # list; Python moves int32 indices into it and packed lanes out of it.

    def verify_inputs_idx(
        self,
        ntxs: Sequence[NativeTx],
        n_ins: Sequence[int],
        amounts: Sequence[int],
        script_pubkeys: Sequence[bytes],
        flags: Sequence[int],
        n_threads: int = 1,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Deferring interpretation of many inputs in one C call, sharded
        across `n_threads` threads (the GIL is released for the call).
        Returns (ok, err, unknown, rec_idx, rec_bounds): input i's oracle
        misses are the uniq indices rec_idx[rec_bounds[i]:rec_bounds[i+1]]."""
        n = len(ntxs)
        if not n == len(n_ins) == len(amounts) == len(script_pubkeys) == len(flags):
            raise ValueError("verify_inputs_idx: argument lengths differ")
        return self._run_idx(
            np.array([t._ptr for t in ntxs], dtype=np.uintp),
            np.array(n_ins, dtype=np.int32), np.array(amounts, dtype=np.int64),
            b"".join(script_pubkeys), _offsets(script_pubkeys),
            np.array(flags, dtype=np.int32), n_threads)

    def verify_inputs_idx_raw(
        self,
        tx_ptrs: Sequence[int],
        n_ins: np.ndarray,
        amounts: np.ndarray,
        spk_blob: np.ndarray,
        spk_offs: np.ndarray,
        flags: np.ndarray,
        n_threads: int = 1,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """`verify_inputs_idx` over arrays: raw tx pointers, and the
        scriptPubKeys as one uint8 blob with int64 offsets, as the block
        accounting hands them over."""
        n = len(tx_ptrs)
        if not n == len(n_ins) == len(amounts) == len(flags) == len(spk_offs) - 1:
            raise ValueError("verify_inputs_idx_raw: argument lengths differ")
        return self._run_idx(
            np.array(tx_ptrs, dtype=np.uintp),
            np.ascontiguousarray(n_ins, dtype=np.int32),
            np.ascontiguousarray(amounts, dtype=np.int64),
            np.ascontiguousarray(spk_blob, dtype=np.uint8),
            np.ascontiguousarray(spk_offs, dtype=np.int64),
            np.ascontiguousarray(flags, dtype=np.int32), n_threads)

    def _run_idx(self, tx_ptrs, nin_a, amt_a, blob, spk_offs, flg_a, n_threads):
        n = len(tx_ptrs)
        if n == 0:
            z = np.zeros(0, np.int32)
            return z, z, z, z, np.zeros(1, np.int64)
        L = lib()
        ok = np.zeros(n, dtype=np.int32)
        err = np.zeros(n, dtype=np.int32)
        unk = np.zeros(n, dtype=np.int32)
        bounds = np.zeros(n + 1, dtype=np.int64)
        L.nat_verify_inputs_idx(
            self._ptr, _addr(tx_ptrs), _addr(nin_a), _addr(amt_a),
            blob if isinstance(blob, bytes) else _addr(blob), _addr(spk_offs),
            _addr(flg_a), n, int(n_threads), _addr(ok), _addr(err), _addr(unk),
            _addr(bounds))
        n_idx = int(bounds[n])
        rec_idx = np.zeros(n_idx, dtype=np.int32)
        if n_idx:
            got = int(L.nat_session_recidx_data(self._ptr, _addr(rec_idx), n_idx))
            if got != n_idx:
                raise RuntimeError(f"nat_session_recidx_data copied {got} of "
                                   f"{n_idx} indices")
        return ok, err, unk, rec_idx, bounds

    def uniq_count(self) -> int:
        """The length of the session's uniq list."""
        return int(lib().nat_session_uniq_count(self._ptr))

    def uniq_lanes(self, idxs: np.ndarray, size: int):
        """The packed lanes of the uniq entries `idxs`, padded to `size`:
        `prep_pack`'s 7-tuple, with no check bytes crossing the bridge."""
        n = len(idxs)
        if size < n:
            raise ValueError(f"size {size} < {n} lanes")
        idx_a = np.ascontiguousarray(idxs, dtype=np.int32)
        fields = np.zeros((size, 4, 32), dtype=np.uint8)
        want_odd = np.zeros(size, dtype=np.int32)
        parity = np.full(size, -1, dtype=np.int32)
        has_t2 = np.zeros(size, dtype=np.int32)
        neg1 = np.zeros(size, dtype=np.int32)
        neg2 = np.zeros(size, dtype=np.int32)
        valid_i = np.zeros(size, dtype=np.int32)
        if n:
            lib().nat_session_uniq_lanes(
                self._ptr, _addr(idx_a), n, _addr(fields), _addr(want_odd),
                _addr(parity), _addr(has_t2), _addr(neg1), _addr(neg2),
                _addr(valid_i))
        return fields, want_odd, parity, has_t2, neg1, neg2, valid_i != 0

    def uniq_digests(self, salt: bytes, idxs: np.ndarray) -> np.ndarray:
        """(n, 32) uint8: the salted sig-cache keys of the uniq entries
        `idxs`, byte-equal to `digest_checks` of the same checks."""
        n = len(idxs)
        out = np.zeros((n, 32), dtype=np.uint8)
        if n:
            idx_a = np.ascontiguousarray(idxs, dtype=np.int32)
            lib().nat_session_uniq_digests(self._ptr, salt, len(salt),
                                           _addr(idx_a), n, _addr(out))
        return out

    def publish_uniq(self, idxs: np.ndarray, results: np.ndarray) -> None:
        """Publish the verdicts of the uniq entries `idxs` into the oracle."""
        n = len(idxs)
        if n != len(results):
            raise ValueError("publish_uniq: argument lengths differ")
        if n:
            idx_a = np.ascontiguousarray(idxs, dtype=np.int32)
            res_a = np.ascontiguousarray(results, dtype=np.int32)
            lib().nat_session_publish_uniq(self._ptr, _addr(idx_a), n, _addr(res_a))

    def uniq_host_verify(self, idx: int) -> bool:
        """The exact host verdict of uniq entry `idx` (the fixup of a lane
        the kernel flags `needs_host`)."""
        return bool(lib().nat_session_uniq_host_verify(self._ptr, int(idx)))

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


# BlkReason codes of block.hpp, in order (the index is the code), as the
# reference's reject-reason strings.
BLOCK_REASONS = (
    None,
    "high-hash",
    "bad-txnmrklroot",
    "bad-txns-duplicate",
    "bad-blk-length",
    "bad-cb-missing",
    "bad-cb-multiple",
    "bad-txns-vin-empty",
    "bad-txns-vout-empty",
    "bad-txns-oversize",
    "bad-txns-vout-negative",
    "bad-txns-vout-toolarge",
    "bad-txns-txouttotal-toolarge",
    "bad-txns-inputs-duplicate",
    "bad-cb-length",
    "bad-txns-prevout-null",
    "bad-blk-sigops",
    "bad-witness-nonce-size",
    "bad-witness-merkle-match",
    "unexpected-witness",
    "bad-txns-BIP30",
    "bad-txns-inputs-missingorspent",
    "bad-txns-premature-spend-of-coinbase",
    "bad-txns-inputvalues-outofrange",
    "bad-txns-in-belowout",
    "bad-txns-fee-outofrange",
    "bad-cb-amount",
    "block-deserialize-failed",
)


class NativeBlockTx:
    """A transaction inside a `NativeBlock`, borrowed: the block owns and
    frees it, and the handle keeps its block alive. It stands in for a
    `NativeTx` where the drivers need one (`_ptr`, `n_inputs`, `ser_size`,
    `wtxid`)."""

    __slots__ = ("_ptr", "_blk", "_index", "n_inputs", "ser_size", "_wtxid",
                 "__weakref__")

    def __init__(self, blk: "NativeBlock", index: int, ptr: int):
        L = lib()
        self._blk = blk
        self._index = index
        self._ptr = ptr
        self.n_inputs = int(L.nat_tx_n_inputs(ptr))
        self.ser_size = int(L.nat_tx_ser_size(ptr))
        self._wtxid: Optional[bytes] = None

    @property
    def wtxid(self) -> bytes:
        if self._wtxid is None:
            self._wtxid = self._blk.wtxid(self._index)
        return self._wtxid


class NativeBlock:
    """A parsed block on the C++ side (block.hpp `NBlock`): header, txs,
    txids and wtxids, and after `accounting` the script phase's per-input
    data. It pickles (and copies) by its serialized bytes, and parses anew
    on load."""

    __slots__ = ("_ptr", "_raw", "n_tx", "n_inputs", "_txs")

    def __init__(self, raw: bytes):
        L = lib()
        self._ptr = None
        raw = bytes(raw)
        ptr = L.nat_block_parse(raw, len(raw))
        if not ptr:
            raise ValueError("block deserialize failed")
        self._ptr = ptr
        self._raw = raw
        self.n_tx = int(L.nat_block_n_tx(ptr))
        self.n_inputs = int(L.nat_block_n_inputs(ptr))
        # Weak values: a NativeBlockTx holds its block, so strong entries
        # here would make a cycle that only the cyclic collector frees.
        self._txs = weakref.WeakValueDictionary()

    def __del__(self):
        if _lib is not None and getattr(self, "_ptr", None):
            _lib.nat_block_free(self._ptr)
            self._ptr = None

    def __reduce__(self):
        return (NativeBlock, (self._raw,))

    def _check_index(self, i: int) -> int:
        if not 0 <= i < self.n_tx:
            raise IndexError(f"tx {i} of a block of {self.n_tx}")
        return i

    def tx(self, i: int) -> NativeBlockTx:
        t = self._txs.get(i)
        if t is None:
            ptr = lib().nat_block_tx(self._ptr, self._check_index(i))
            t = self._txs[i] = NativeBlockTx(self, i, ptr)
        return t

    def txid(self, i: int) -> bytes:
        out = ctypes.create_string_buffer(32)
        lib().nat_block_txid(self._ptr, self._check_index(i), out)
        return out.raw

    def wtxid(self, i: int) -> bytes:
        out = ctypes.create_string_buffer(32)
        lib().nat_block_wtxid(self._ptr, self._check_index(i), out)
        return out.raw

    def check(self, check_pow: bool, pow_limit: int, check_merkle: bool = True
              ) -> Optional[str]:
        """Context-free CheckBlock: a reject reason, or None."""
        code = lib().nat_block_check(self._ptr, 1 if check_pow else 0,
                                     pow_limit.to_bytes(32, "big"),
                                     1 if check_merkle else 0)
        return BLOCK_REASONS[code]

    def check_witness_commitment(self) -> Optional[str]:
        """The BIP141 witness-commitment rules: a reject reason, or None."""
        return BLOCK_REASONS[lib().nat_block_check_witness(self._ptr)]

    def accounting(self, view: "NativeCoinsView", height: int, flags: int):
        """ConnectBlock's accounting against `view` (BIP30, existence,
        maturity, values, fees, the sigop budget, the coinbase reward) and
        the per-tx hash precompute. Returns (reason or None, fees,
        sigop_cost, tx_index, n_in, amounts, spk_offs, spk_blob), the arrays
        one entry per non-coinbase input in block order (None on a reject)."""
        L = lib()
        code = L.nat_block_accounting(self._ptr, view._ptr, height, flags)
        meta = np.zeros(4, dtype=np.int64)  # fees, sigop cost, inputs, spk bytes
        L.nat_block_acct_meta(self._ptr, _addr(meta[0:]), _addr(meta[1:]),
                              _addr(meta[2:]), _addr(meta[3:]))
        fees, sigops, n, spk_bytes = (int(v) for v in meta)
        if code != 0:
            return (BLOCK_REASONS[code], fees, sigops) + (None,) * 5
        tx_index = np.zeros(n, np.int32)
        n_in = np.zeros(n, np.int32)
        amounts = np.zeros(n, np.int64)
        spk_offs = np.zeros(n + 1, np.int64)
        spk_blob = np.zeros(spk_bytes, np.uint8)
        L.nat_block_acct_data(self._ptr, _addr(tx_index), _addr(n_in),
                              _addr(amounts), _addr(spk_offs), _addr(spk_blob))
        return None, fees, sigops, tx_index, n_in, amounts, spk_offs, spk_blob

    def spent_digests(self) -> np.ndarray:
        """(n_tx, 32) per-tx spent-output digests, coinbase rows zero; valid
        after a successful `accounting`."""
        out = np.zeros((self.n_tx, 32), dtype=np.uint8)
        lib().nat_block_spent_digests(self._ptr, _addr(out))
        return out

    def script_keys(self, salt: bytes, flags: int) -> np.ndarray:
        """(n_inputs, 32) script-execution-cache keys of every non-coinbase
        input, byte-equal to `ScriptExecutionCache`'s; valid after a
        successful `accounting`."""
        out = np.zeros((self.n_inputs, 32), dtype=np.uint8)
        lib().nat_block_script_keys(self._ptr, salt, len(salt), flags, _addr(out))
        return out


class NativeCoinsView:
    """The UTXO set on the C++ side (block.hpp `NView`), with the
    `models/validate.CoinsView` methods, a batch insert and a copying
    `clone`. It does not pickle: it is a handle."""

    __slots__ = ("_ptr",)

    def __init__(self, _ptr: Optional[int] = None):
        self._ptr = None
        self._ptr = lib().nat_view_new() if _ptr is None else _ptr

    def __del__(self):
        if _lib is not None and getattr(self, "_ptr", None):
            _lib.nat_view_free(self._ptr)
            self._ptr = None

    def __reduce__(self):
        raise TypeError("a NativeCoinsView is a native handle and does not pickle")

    def clone(self) -> "NativeCoinsView":
        return NativeCoinsView(lib().nat_view_clone(self._ptr))

    def __deepcopy__(self, memo) -> "NativeCoinsView":
        return self.clone()

    def __len__(self) -> int:
        return int(lib().nat_view_len(self._ptr))

    def add_coins_batch(self, coins: Sequence[Tuple[bytes, int, int, int, bool, bytes]]
                        ) -> None:
        """Insert (txid32, n, value, height, coinbase, spk) coins in one call."""
        n = len(coins)
        if n == 0:
            return
        txids = b"".join(c[0] for c in coins)
        if len(txids) != 32 * n:
            raise ValueError("every txid must be 32 bytes")
        ns = np.array([c[1] for c in coins], dtype=np.int32)
        values = np.array([c[2] for c in coins], dtype=np.int64)
        heights = np.array([c[3] for c in coins], dtype=np.int32)
        cbs = np.array([1 if c[4] else 0 for c in coins], dtype=np.int32)
        spks = [c[5] for c in coins]
        offs = _offsets(spks)
        lib().nat_view_add_coins(self._ptr, n, txids, _addr(ns), _addr(values),
                                 _addr(heights), _addr(cbs), b"".join(spks),
                                 _addr(offs))

    @staticmethod
    def _hash(outpoint) -> bytes:
        if len(outpoint.hash) != 32:
            raise ValueError("an outpoint's hash must be 32 bytes")
        return bytes(outpoint.hash)

    def add(self, outpoint, coin) -> None:
        self.add_coins_batch([(outpoint.hash, outpoint.n, coin.out.value,
                               coin.height, coin.coinbase, coin.out.script_pubkey)])

    def add_tx(self, tx, height: int) -> None:
        cb = tx.is_coinbase()
        self.add_coins_batch([(tx.txid, n, out.value, height, cb, out.script_pubkey)
                              for n, out in enumerate(tx.vout)])

    def get(self, outpoint):
        """The `Coin` at `outpoint`, or None."""
        from .core.tx import TxOut
        from .models.validate import Coin

        L = lib()
        txid = self._hash(outpoint)
        meta = np.zeros(4, dtype=np.int64)  # value, spk length; height, coinbase
        hc = np.zeros(2, dtype=np.int32)
        if not L.nat_view_get(self._ptr, txid, outpoint.n, _addr(meta[0:]),
                              _addr(hc[0:]), _addr(hc[1:]), _addr(meta[1:])):
            return None
        spk = ctypes.create_string_buffer(max(int(meta[1]), 1))
        L.nat_view_get_spk(self._ptr, txid, outpoint.n, spk)
        return Coin(TxOut(int(meta[0]), spk.raw[: int(meta[1])]), int(hc[0]),
                    bool(hc[1]))

    def spend(self, outpoint):
        """Remove and return the `Coin` at `outpoint` (None if absent)."""
        coin = self.get(outpoint)
        if coin is not None:
            lib().nat_view_spend(self._ptr, self._hash(outpoint), outpoint.n)
        return coin

    def apply_block(self, blk: NativeBlock, height: int) -> None:
        """Spend every input of `blk` and add its outputs (UpdateCoins)."""
        lib().nat_view_apply_block(self._ptr, blk._ptr, height)


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
