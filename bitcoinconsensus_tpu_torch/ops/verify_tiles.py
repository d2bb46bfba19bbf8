"""The batched verify kernel: R = a·G + (±b1 ± λ·b2)·P per lane.

Counterpart of `bitcoinconsensus_tpu/ops/pallas_kernel.py::verify_tiles`.
Three pieces live here:

- `verify_tiles(...)`, the wrapper. For tensors on a CUDA device it checks
  them and launches the hand-written kernel `csrc/verify_tiles.cu` (built at
  first use by `_build.py`), counting each launch in `verify_tiles.launches`;
  a launch that fails raises. For tensors on the CPU it runs the plain
  version.
- `verify_tiles_reference(...)`, the plain version in the port's torch ops
  (`limbs.py`, `curve.py`), step for step the TPU kernel's schedule
  (`pallas_kernel.py:244-428`), with a per-lane Fermat inverse in place of
  the tile-wide batch inverse (affine coordinates are unique, so verdicts
  do not change).
- The preamble (`_signed_digits128`, t1 + n), shared with the plain version;
  the CUDA kernel does the same per lane.

The checked launch carries a dispatch's guard in the same kernel:

- `verify_tiles_checked(..., live=None, ok_out=None, needs_out=None,
  partials=True)` launches `vt_verify_tiles_checked` on CUDA tensors
  (counted in `verify_tiles_checked.launches`, and those that wrote
  partials in `.checksummed`): the same lane program,
  which stores the verdicts as bool bytes into the caller's buffers (or
  new ones) and, with `partials`, each warp's (count, weighted sum,
  failures) into a (3, ceil(B / 32)) int32 buffer: the terms of
  `ops/verdict_checksum.py` and `ops/shard_step.py`, per warp. CPU tensors
  run `verify_tiles_checked_reference`: `verify_tiles_reference`, then
  `epilogue_reference`, the epilogue's plain per-warp sums in int64.
- `epilogue_sums(partials)` sums a launch's warps into the (count,
  weighted sum, failures) triple the guards compare.

Two probes run pieces of the kernel's own device code alone: `field_op`
(its field layer, `vt_field_op`) and `recode` (its signed recoder,
`vt_recode`), each against its plain version on the CPU.

Inputs are the verifier's packed 7-tuple: `fields` (B, 4, 32) uint8
little-endian (a, |b1|‖|b2|, px, t1), then int32 (B,) `want_odd`,
`parity_req`, `has_t2`, `neg1`, `neg2` and bool (B,) `valid`. Outputs are
(B,) bool `(ok, needs_host)`; `needs_host` marks an equal-points case the
fast adds do not compute, which the caller must resolve on the host.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch

from ..crypto.secp_host import N as _N_INT
from . import launch
from .contract import LaunchContract, Window, cdiv
from .curve import (
    G_WINDOW_BITS,
    G_WINDOWS,
    _BETA_LIMBS,
    _GX_LIMBS,
    _GY_LIMBS,
    _digits,
    _digits128,
    _inf_like,
    _ones_like,
    _select,
    g_table,
    jacobian_add_flagged,
    jacobian_double,
    jacobian_madd_flagged,
    jacobian_madd_flagged_ratio,
)
from .gen_gtable import affine_table
from .limbs import (
    MASK,
    NLIMB,
    _col,
    bytes_to_limbs,
    fe_add,
    fe_canon,
    fe_inv_chain,
    fe_is_zero,
    fe_mul,
    fe_mul_small,
    fe_sqr,
    fe_sqrt_chain,
    fe_sub,
    int_to_limbs,
)

__all__ = ["verify_tiles", "verify_tiles_reference", "VERIFY_TILES_CONTRACT",
           "verify_tiles_checked", "verify_tiles_checked_reference",
           "epilogue_reference", "epilogue_sums", "VERIFY_TILES_CHECKED_CONTRACT",
           "SGLV_WINDOWS", "SGLV_WIDTH", "field_op", "recode"]

# Signed 5-bit windows over the 128-bit GLV halves: 26 windows of
# (5 doublings + 2 mixed adds); digits in [-16, 15], table {1..16}·P.
SGLV_WINDOWS = 26
SGLV_WIDTH = 5

_SEVEN = int_to_limbs(7)
_N_LIMBS = int_to_limbs(_N_INT)


def _signed_digits128(limbs10: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(10, B) limbs of a value < 2^128 -> ((26, B) |digit|, (26, B) sign)
    with digit ∈ [-16, 15] and sum digit_i·32^i equal to the value. The
    top window never carries out (bits 125..127 + carry <= 8 < 16)."""
    raw = _digits128(limbs10, count=SGLV_WINDOWS, width=SGLV_WIDTH)
    carry = torch.zeros_like(raw[0])
    ds = []
    for w in range(SGLV_WINDOWS):
        t = raw[w] + carry
        neg = t >= 16
        carry = neg.to(torch.int32)
        ds.append(torch.where(neg, t - 32, t))
    ds = torch.stack(ds)
    return ds.abs(), (ds < 0).to(torch.int32)


def _preamble(fields: torch.Tensor):
    """Byte unpack, window digits and the t1 + n secondary target."""
    a = bytes_to_limbs(fields[:, 0])
    b1 = bytes_to_limbs(fields[:, 1, :16], nlimb=10)  # GLV halves
    b2 = bytes_to_limbs(fields[:, 1, 16:], nlimb=10)
    px = bytes_to_limbs(fields[:, 2])
    t1 = bytes_to_limbs(fields[:, 3])
    da = _digits(a, G_WINDOW_BITS, G_WINDOWS)  # (32, B)
    db1, ds1 = _signed_digits128(b1)  # (26, B) each
    db2, ds2 = _signed_digits128(b2)
    # t1 ships RAW (exact 13-bit limbs from bytes): a target >= p must never
    # equal a canonical x, so it is not reduced. t1 + n is only used when
    # has_t2 certifies r + n < p.
    t1n = fe_canon(t1 + _col(_N_LIMBS, t1), bounds=[2 * MASK] * NLIMB)
    return px, t1, t1n, da, db1, ds1, db2, ds2


def _pick(table: torch.Tensor, digit: torch.Tensor) -> torch.Tensor:
    """Row digit-1 of a per-lane (16, 20, B) table -> (20, B); lanes with
    digit 0 read row 0 and are not applied by the caller."""
    idx = (digit - 1).clamp(min=0).long()
    lanes = torch.arange(table.shape[-1], device=table.device)
    return table[idx, :, lanes].T


def verify_tiles_reference(fields, want_odd, parity_req, has_t2, neg1, neg2,
                           valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the verify kernel (same arguments, same
    outputs), on whatever device the tensors lie."""
    px, t1, t1n, da, db1, ds1, db2, ds2 = _preamble(fields)
    want_odd = want_odd.to(torch.int32)
    parity_req = parity_req.to(torch.int32)
    has_t2 = has_t2.to(torch.int32)
    neg1i = neg1.to(torch.int32)
    neg2i = neg2.to(torch.int32)
    valid = valid.to(torch.int32) != 0

    # -- lift P's y from (x, parity): y = sqrt(x^3 + 7), flip to parity -----
    rhs = fe_add(fe_mul(fe_sqr(px), px), _col(_SEVEN, px))
    ycand = fe_canon(fe_sqrt_chain(rhs))
    sq_ok = fe_is_zero(fe_sub(fe_mul(ycand, ycand), rhs))
    odd = (ycand[0] & 1) == 1
    yneg = fe_sub(torch.zeros_like(ycand), ycand)
    flip = odd != (want_odd == 1)
    py = torch.where(flip[None], yneg, ycand)
    valid = valid & sq_ok
    # Invalid (off-curve) lanes run on G; their verdicts stay masked.
    px = torch.where(valid[None], px, _col(_GX_LIMBS, px))
    py = torch.where(valid[None], py, _col(_GY_LIMBS, py))

    # -- per-lane table {1..16}·P, renormalised to one global Z ------------
    ones = _ones_like(px)
    needs = torch.zeros_like(valid)
    TX, TY = [px], [py]
    ratios = [None, fe_mul_small(py, 2)]  # Z_1 = 2·py·1 (Z_0 = 1)
    X, Y, Z = jacobian_double(px, py, ones)
    TX.append(X)
    TY.append(Y)
    for _k in range(2, 16):
        X, Y, Z, _inf, ndbl, ratio = jacobian_madd_flagged_ratio(
            X, Y, Z, px, py, inf1=False
        )
        TX.append(X)
        TY.append(Y)
        ratios.append(ratio)
        needs = needs | ndbl
    # Rescale rows 14..0 to row 15's Z: c_k = prod_{j=k+1..15} ratio_j.
    c = None
    for k in range(14, -1, -1):
        c = ratios[k + 1] if c is None else fe_mul(c, ratios[k + 1])
        c2 = fe_sqr(c)
        TX[k] = fe_mul(TX[k], c2)
        TY[k] = fe_mul(TY[k], fe_mul(c2, c))
    global_z = c
    TX, TY = torch.stack(TX), torch.stack(TY)  # (16, 20, B)

    # -- (±b1 ± λ·b2)·P: 26 signed windows on the global-Z curve ----------
    beta = _col(_BETA_LIMBS, px)

    def madd_step(R, r_inf, nh, d, sign, selx, sely):
        sely = torch.where((sign == 1)[None],
                           fe_sub(torch.zeros_like(sely), sely), sely)
        Xa, Ya, Za, inf_a, nd = jacobian_madd_flagged(*R, selx, sely, inf1=r_inf)
        app = d > 0
        R = _select(app, (Xa, Ya, Za), R)
        return R, torch.where(app, inf_a, r_inf), nh | (app & nd)

    R = _inf_like(px)
    r_inf = torch.ones_like(valid)
    for i in range(SGLV_WINDOWS):
        w = SGLV_WINDOWS - 1 - i
        for _ in range(5):
            R = jacobian_double(*R)  # doublings preserve infinity
        d1 = db1[w]
        R, r_inf, needs = madd_step(R, r_inf, needs, d1, ds1[w] ^ neg1i,
                                    _pick(TX, d1), _pick(TY, d1))
        d2 = db2[w]
        R, r_inf, needs = madd_step(R, r_inf, needs, d2, ds2[w] ^ neg2i,
                                    fe_mul(_pick(TX, d2), beta), _pick(TY, d2))
    X, Y, Z = R
    Z = fe_mul(Z, global_z)  # back to the true curve

    # -- a·G: 32 windows against the affine table ----------------------------
    gx, gy = g_table(px.device)
    Rg = _inf_like(px)
    rg_inf = torch.ones_like(valid)
    for i in range(G_WINDOWS):
        d = da[i]
        idx = (d - 1).clamp(min=0).long()
        Xa, Ya, Za, inf_a, nd = jacobian_madd_flagged(
            *Rg, gx[i][idx].T, gy[i][idx].T, inf1=rg_inf
        )
        app = d > 0
        Rg = _select(app, (Xa, Ya, Za), Rg)
        rg_inf = torch.where(app, inf_a, rg_inf)
        needs = needs | (app & nd)

    X, Y, Z, inf_mask, nd_join = jacobian_add_flagged(
        X, Y, Z, *Rg, rg_inf, inf1=r_inf
    )
    needs = (needs | nd_join) & valid  # invalid lanes never defer

    # -- affine + accept --------------------------------------------------------
    zi = fe_inv_chain(Z)
    zi2 = fe_sqr(zi)
    x = fe_canon(fe_mul(X, zi2))
    y = fe_canon(fe_mul(Y, fe_mul(zi2, zi)))
    ok_x = (x == t1).all(dim=0) | ((has_t2 == 1) & (x == t1n).all(dim=0))
    y_odd = (y[0] & 1) == 1
    par_ok = (parity_req < 0) | (y_odd == (parity_req == 1))
    ok = valid & ~inf_mask & ok_x & par_ok & ~needs
    return ok, needs


# ---------------------------------------------------------------------------
# The CUDA kernel.

_gtab_lock = threading.Lock()
_gtab: Dict[torch.device, torch.Tensor] = {}
GTAB_SHAPE = (G_WINDOWS, 255, 2, 8)


def gtable_words(device: torch.device) -> torch.Tensor:
    """The G window table as canonical affine words, (32, 255, 2, 8) int32
    holding little-endian uint32 words, on `device` (built once per
    device)."""
    device = torch.device(device)
    with _gtab_lock:
        if device not in _gtab:
            raw = b"".join(
                x.to_bytes(32, "little") + y.to_bytes(32, "little")
                for window in affine_table() for x, y in window
            )
            words = np.frombuffer(raw, dtype="<u4").astype(np.uint32)
            words = words.view(np.int32).reshape(GTAB_SHAPE)
            _gtab[device] = torch.from_numpy(words.copy()).to(device)
        return _gtab[device]


def _check(fields, flags, valid) -> int:
    if fields.dtype != torch.uint8 or fields.dim() != 3 or fields.shape[1:] != (4, 32):
        raise ValueError(f"fields must be (B, 4, 32) uint8, got "
                         f"{tuple(fields.shape)} {fields.dtype}")
    B = fields.shape[0]
    if valid.dtype != torch.bool or valid.shape != (B,):
        raise ValueError(f"valid must be ({B},) bool, got {tuple(valid.shape)} "
                         f"{valid.dtype}")
    for t in flags:
        if t.dtype != torch.int32 or t.shape != (B,):
            raise ValueError(f"flag vectors must be ({B},) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in (fields, valid, *flags):
        if t.device != fields.device:
            raise ValueError("all inputs must lie on one device")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if fields.data_ptr() % 16:
        raise ValueError("fields must be 16-byte aligned")
    return B


def _contract_body(block, fields, want_odd, parity_req, has_t2, neg1, neg2,
                   valid, gtab):
    # The plain version reads its own limb-form G table, made from the same
    # `affine_table` as the words the kernel reads.
    ok, needs = verify_tiles_reference(fields, want_odd, parity_req, has_t2,
                                       neg1, neg2, valid)
    return torch.stack([ok, needs]).to(torch.int32)


_VT_THREADS = 64  # csrc/verify_tiles.cu: __launch_bounds__(64, 1), one lane each
# The kernel's per-lane shared slots (csrc/verify_tiles.cu `vt_slots`),
# [slot][word][lane]: the {1..16}·P table as (entry, x|y, word, lane), and
# the rescale ratios 1..15. The addition chains reuse the table's first
# slots while it is not live.
_VT_SMEM = (((16, 2, 8, _VT_THREADS), torch.int32),
            ((15, 8, _VT_THREADS), torch.int32))


def _lanes(*rest: int) -> Window:
    return Window((_VT_THREADS,) + rest,
                  lambda b: (_VT_THREADS * b[0],) + (0,) * len(rest))


# The launch of `vt_verify_tiles`: one thread per lane in 64-thread blocks,
# the ragged last block masked in the kernel (`if (i >= n) return`), and
# 96,256 bytes of dynamic shared memory a block for the lanes' own slots
# (no lane reads another's, so no barrier); every block reads the whole G
# table and writes its lanes' columns of the (2, B) int32 result. `_launch`
# takes the grid, the threads, the shared bytes and the output's shape from
# here, and the C launcher refuses any other launch. The body is the plain
# version: its interval proof (`cuda.verify_tiles.body`) covers
# `verify_tiles_reference`'s 20x13-bit arithmetic, not the kernel's 8x32-bit
# words, which are held to it bit for bit on the card instead (and on the
# host, through the lane program's portable build).
VERIFY_TILES_CONTRACT = LaunchContract(
    "verify_tiles",
    grid=lambda fields, *_: (cdiv(fields[0], _VT_THREADS),),
    threads=_VT_THREADS,
    ins=(_lanes(4, 32),) + (_lanes(),) * 6
    + (Window(GTAB_SHAPE, lambda b: (0, 0, 0, 0)),),
    outs=(Window((2, _VT_THREADS), lambda b: (0, _VT_THREADS * b[0])),),
    out_arrays=lambda fields, *_: (((2, fields[0]), torch.int32),),
    body=_contract_body,
    masked_edge=True,
    dynamic_smem=_VT_SMEM,
)

def _launch(fields, want_odd, parity_req, has_t2, neg1, neg2, valid):
    B = _check(fields, (want_odd, parity_req, has_t2, neg1, neg2), valid)
    fn = launch.bind("verify_tiles", "vt_verify_tiles")
    gtab = gtable_words(fields.device)
    c = VERIFY_TILES_CONTRACT
    (grid,) = c.grid(tuple(fields.shape))
    ((shape, dtype),) = c.out_arrays(tuple(fields.shape))
    out = torch.empty(shape, dtype=dtype, device=fields.device)
    launch.call(fn, fields.get_device(), fields.data_ptr(), want_odd.data_ptr(),
                parity_req.data_ptr(), has_t2.data_ptr(), neg1.data_ptr(),
                neg2.data_ptr(), valid.data_ptr(), gtab.data_ptr(),
                out.data_ptr(), B, grid, c.threads, c.dynamic_smem_bytes())
    verify_tiles.launches += 1
    return out[0] != 0, out[1] != 0


# ---------------------------------------------------------------------------
# The checked launch: the lane program and its epilogue in one kernel.

CHECKSUM_MOD = 251  # csrc/verify_tiles.cu VT_CHECK_MOD, the checksum's modulus
WARP = 32
# csrc/verify_tiles.cu VT_CHECKED_MAX_LANES: 251 * 2^23 < 2^31, so a launch's
# summed weights fit int32, as `ops/verdict_checksum.MAX_LANES`.
MAX_CHECKED_LANES = 1 << 23


def _epilogue_terms(ok, needs, live, first: int, dtype):
    """The (3, L) terms of L lanes from lane index `first`: ok, ok·(i % 251
    + 1), live ∧ ¬ok ∧ ¬needs (zeros without `live`)."""
    v = ok.to(dtype)
    i = torch.arange(v.shape[0], dtype=dtype, device=v.device) + first
    fails = (live & ~ok & ~needs).to(dtype) if live is not None else torch.zeros_like(v)
    return torch.stack((v, v * (i % CHECKSUM_MOD + 1), fails))


def _warp_sums(terms, dtype):
    """(3, L) terms -> (3, ceil(L / 32)) sums of each warp's 32 lanes."""
    n = terms.shape[1]
    n_warps = cdiv(n, WARP)
    if n_warps * WARP != n:
        terms = torch.cat((terms, terms.new_zeros((3, n_warps * WARP - n))), dim=1)
    return terms.reshape(3, n_warps, WARP).sum(dim=2, dtype=dtype)


def epilogue_reference(ok, needs, live=None, ok_out=None, needs_out=None,
                       partials=True):
    """The checked launch's epilogue on a launch's (B,) bool verdicts, in
    plain torch: the verdicts copied into `ok_out` / `needs_out` where
    given, and, with `partials` (True, or a (3, ceil(B / 32)) buffer to
    copy them into), the per-warp sums of count, weighted sum and failures
    (lane i weighted i % 251 + 1), in int64. Returns (ok, needs, partials
    or None)."""
    if ok_out is not None:
        ok = ok_out.copy_(ok)
    if needs_out is not None:
        needs = needs_out.copy_(needs)
    if partials is False or partials is None:
        return ok, needs, None
    sums = _warp_sums(_epilogue_terms(ok, needs, live, 0, torch.int64), torch.int64)
    return ok, needs, sums if partials is True else partials.copy_(sums)


def verify_tiles_checked_reference(fields, want_odd, parity_req, has_t2, neg1,
                                   neg2, valid, live=None, ok_out=None,
                                   needs_out=None, partials=True):
    """Plain version of the checked launch: `verify_tiles_reference`, then
    `epilogue_reference`."""
    ok, needs = verify_tiles_reference(fields, want_odd, parity_req, has_t2,
                                       neg1, neg2, valid)
    return epilogue_reference(ok, needs, live, ok_out, needs_out, partials)


def epilogue_sums(partials) -> Tuple[int, int, int]:
    """(count, weighted sum, failures) of a launch: its (3, n_warps)
    per-warp partials (a tensor on the CPU or an array) summed over the
    warps, in int64."""
    p = np.asarray(partials, dtype=np.int64)
    if p.ndim != 2 or p.shape[0] != 3:
        raise ValueError(f"partials must be (3, n_warps), got {p.shape}")
    count, wsum, fails = p.sum(axis=1).tolist()
    return count, wsum, fails


def _checked_contract_body(block, fields, want_odd, parity_req, has_t2, neg1,
                           neg2, valid, gtab, live):
    ok, needs = verify_tiles_reference(fields, want_odd, parity_req, has_t2,
                                       neg1, neg2, valid)
    return ok, needs, epilogue_block(block, ok, needs, live)


def epilogue_block(block, ok, needs, live):
    """One block's epilogue in the kernel's int32 arithmetic: its (L,)
    lanes' verdicts and `live` -> the (3, ceil(L / 32)) int32 sums of its
    warps, lane i of the launch at 64·block + its place in the block."""
    terms = _epilogue_terms(ok, needs, live, _VT_THREADS * block[0], torch.int32)
    return _warp_sums(terms, torch.int32)


# The launch of `vt_verify_tiles_checked`: `VERIFY_TILES_CONTRACT`'s grid,
# threads and shared slots, one more input (`live`, the lanes whose failure
# counts; the launcher takes a null one as all false) and three outputs:
# the block's columns of the (B,) bool ok and needs, and its two warps'
# columns of the (3, ceil(B / 32)) int32 partials, each written once (the
# ragged edge masked: a warp wholly past B writes nothing). The body is the
# plain version and the epilogue's int32 sums (`epilogue_block`), which
# the prover holds inside int32 (`cuda.verify_tiles_checked`).
VERIFY_TILES_CHECKED_CONTRACT = LaunchContract(
    "verify_tiles_checked",
    grid=VERIFY_TILES_CONTRACT.grid,
    threads=_VT_THREADS,
    ins=VERIFY_TILES_CONTRACT.ins + (_lanes(),),
    outs=(_lanes(), _lanes(),
          Window((3, _VT_THREADS // WARP),
                 lambda b: (0, _VT_THREADS // WARP * b[0]))),
    out_arrays=lambda fields, *_: (((fields[0],), torch.bool),
                                   ((fields[0],), torch.bool),
                                   ((3, cdiv(fields[0], WARP)), torch.int32)),
    body=_checked_contract_body,
    masked_edge=True,
    dynamic_smem=_VT_SMEM,
)


def _check_bool_lanes(name, t, B, device) -> None:
    if t.dtype != torch.bool or t.shape != (B,) or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({B},) bool tensor on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} {t.device}")


def _launch_checked(fields, flags, valid, live, ok_out, needs_out, parts):
    B = fields.shape[0]
    dev = fields.device
    c = VERIFY_TILES_CHECKED_CONTRACT
    fn = launch.bind("verify_tiles", "vt_verify_tiles_checked")
    gtab = gtable_words(dev)
    (grid,) = c.grid(tuple(fields.shape))
    if ok_out is None:
        ok_out = torch.empty(B, dtype=torch.bool, device=dev)
    if needs_out is None:
        needs_out = torch.empty(B, dtype=torch.bool, device=dev)
    launch.call(fn, fields.get_device(), fields.data_ptr(),
                *(t.data_ptr() for t in flags), valid.data_ptr(), gtab.data_ptr(),
                ok_out.data_ptr(), needs_out.data_ptr(),
                0 if live is None else live.data_ptr(),
                0 if parts is None else parts.data_ptr(),
                B, grid, c.threads, c.dynamic_smem_bytes())
    verify_tiles_checked.launches += 1
    verify_tiles_checked.checksummed += parts is not None
    return ok_out, needs_out, parts


def verify_tiles_checked(fields, want_odd, parity_req, has_t2, neg1, neg2,
                         valid, live=None, ok_out=None, needs_out=None,
                         partials=True):
    """(ok, needs_host, partials or None) of one checked launch: the
    verdicts as (B,) bool, written into `ok_out` / `needs_out` where given
    (contiguous (B,) bool on the inputs' device, as on the mesh, views of
    a card's group buffers), and with `partials` (True, or a contiguous
    (3, ceil(B / 32)) int32 buffer on that device to write them into) the
    per-warp sums of count, weighted sum and, where `live` ((B,) bool)
    marks the lanes that count, failures. CUDA tensors run the
    hand-written kernel (or raise); CPU tensors run
    `verify_tiles_checked_reference`. The partials are int32 either way."""
    flags = (want_odd, parity_req, has_t2, neg1, neg2)
    B = _check(fields, flags, valid)
    if B > MAX_CHECKED_LANES:
        raise ValueError(f"{B} lanes: the checked launch's int32 sums hold at "
                         f"most {MAX_CHECKED_LANES}")
    for name, t in (("live", live), ("ok_out", ok_out), ("needs_out", needs_out)):
        if t is not None:
            _check_bool_lanes(name, t, B, fields.device)
    ((p_shape, p_dtype),) = VERIFY_TILES_CHECKED_CONTRACT.out_arrays(
        tuple(fields.shape))[2:]
    if partials is True:
        parts = torch.empty(p_shape, dtype=p_dtype, device=fields.device)
    elif partials is False or partials is None:
        parts = None
    else:
        parts = partials
        if parts.dtype != p_dtype or tuple(parts.shape) != p_shape \
                or parts.device != fields.device or not parts.is_contiguous():
            raise ValueError(f"partials must be a contiguous {p_shape} int32 tensor "
                             f"on {fields.device}, got {tuple(parts.shape)} "
                             f"{parts.dtype} {parts.device}")
    if fields.is_cuda:
        return _launch_checked(fields, flags, valid, live, ok_out, needs_out, parts)
    if fields.device.type != "cpu":
        raise ValueError(f"verify_tiles_checked runs on CUDA or the CPU, not "
                         f"{fields.device}")
    ok, needs, sums = verify_tiles_checked_reference(
        fields, *flags, valid, live, ok_out, needs_out, parts is not None)
    return ok, needs, None if parts is None else parts.copy_(sums)


verify_tiles_checked.launches = 0
verify_tiles_checked.checksummed = 0  # the launches that wrote partials


FIELD_OPS = ("mul", "sqr", "add", "sub", "mul_int", "canon", "is_zero")
_P_INT = 2**256 - 0x1000003D1
_K_INT = 0x1000003D1
_M256 = (1 << 256) - 1


def _fold(v: int) -> int:
    """csrc/verify_tiles.cu `fe_fold`: v < 2^256·(2^32 + 979) to [0, 2^256),
    the top folded by K twice."""
    v = (v & _M256) + (v >> 256) * _K_INT
    return (v & _M256) + (v >> 256) * _K_INT


def field_model(op: str, a: int, b: int = 0, k: int = 0) -> int:
    """The kernel's lazy field operation on integers in [0, 2^256): the exact
    words it returns, not only their value mod p."""
    if op in ("mul", "sqr"):
        t = a * (a if op == "sqr" else b)
        return _fold((t & _M256) + (t >> 256) * _K_INT)
    if op == "add":
        return _fold(a + b)
    if op == "mul_int":
        return _fold(a * k)
    if op == "sub":
        v = a - b
        for _ in range(2):  # a borrow takes K off the wrapped value, at most twice
            if v >= 0:
                break
            v = (v + (1 << 256)) - _K_INT
        return v & _M256
    if op == "canon":
        return a - _P_INT if a >= _P_INT else a
    if op == "is_zero":
        return int(a % _P_INT == 0)
    raise ValueError(f"unknown field op {op!r}")


def words_to_ints(w: np.ndarray):
    """(n, 8) little-endian 32-bit words (any int dtype) -> n Python ints."""
    w = np.asarray(w).astype(np.int64) & 0xFFFFFFFF
    return [sum(int(x) << (32 * j) for j, x in enumerate(row)) for row in w]


def ints_to_words(vals) -> np.ndarray:
    """n ints in [0, 2^256) -> (n, 8) int32 words."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(raw, dtype="<u4").astype(np.uint32).view(np.int32).reshape(-1, 8)


def field_op(op: str, a: torch.Tensor, b: torch.Tensor, k: int = 0) -> torch.Tensor:
    """The kernel's field layer alone, one operation per row: (n, 8) int32
    words a, b -> (n, 8) words. CUDA tensors run `vt_field_op` (the functions
    the verify kernel inlines); CPU tensors run `field_model`."""
    for t in (a, b):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 8 \
                or not t.is_contiguous() or t.device != a.device:
            raise ValueError("field_op takes contiguous (n, 8) int32 words on one device")
    if b.shape != a.shape:
        raise ValueError("a and b must have one shape")
    if op not in FIELD_OPS:
        raise ValueError(f"unknown field op {op!r}")
    if not a.is_cuda:
        if a.device.type != "cpu":
            raise ValueError(f"field_op runs on CUDA or the CPU, not {a.device}")
        vals = [field_model(op, x, y, k) for x, y in
                zip(words_to_ints(a.numpy()), words_to_ints(b.numpy()))]
        return torch.from_numpy(ints_to_words(vals).copy())
    fn = launch.bind("verify_tiles", "vt_field_op")
    out = torch.empty_like(a)
    launch.call(fn, a.get_device(), FIELD_OPS.index(op), a.data_ptr(),
                b.data_ptr(), k, out.data_ptr(), a.shape[0])
    return out


def words_to_limbs10(words: torch.Tensor) -> torch.Tensor:
    """(n, 4) int32 little-endian words of values below 2^128 -> (10, n)
    13-bit limbs, the layout `_signed_digits128` takes."""
    u8 = words.contiguous().view(torch.uint8).reshape(-1, 16)
    return bytes_to_limbs(u8, nlimb=10)


def recode(words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's signed recoder alone: (n, 4) int32 words of values below
    2^128 -> ((n, 26) |digit|, (n, 26) sign) int32, digit w of window w.
    CUDA tensors run `vt_recode` (the `signed_carries` / `signed_digit` the
    verify kernel inlines); CPU tensors run `_signed_digits128`."""
    if words.dtype != torch.int32 or words.dim() != 2 or words.shape[1] != 4 \
            or not words.is_contiguous():
        raise ValueError("recode takes contiguous (n, 4) int32 words")
    if not words.is_cuda:
        if words.device.type != "cpu":
            raise ValueError(f"recode runs on CUDA or the CPU, not {words.device}")
        mag, sgn = _signed_digits128(words_to_limbs10(words))
        return mag.T.contiguous(), sgn.T.contiguous()
    fn = launch.bind("verify_tiles", "vt_recode")
    mag = torch.empty((words.shape[0], SGLV_WINDOWS), dtype=torch.int32,
                      device=words.device)
    sgn = torch.empty_like(mag)
    launch.call(fn, words.get_device(), words.data_ptr(), mag.data_ptr(),
                sgn.data_ptr(), words.shape[0])
    return mag, sgn


def verify_tiles(fields, want_odd, parity_req, has_t2, neg1, neg2, valid):
    """(ok, needs_host) per lane. CUDA tensors run the hand-written kernel
    (or raise); CPU tensors run `verify_tiles_reference`."""
    if fields.is_cuda:
        return _launch(fields, want_odd, parity_req, has_t2, neg1, neg2, valid)
    if fields.device.type != "cpu":
        raise ValueError(f"verify_tiles runs on CUDA or the CPU, not "
                         f"{fields.device}")
    return verify_tiles_reference(fields, want_odd, parity_req, has_t2, neg1,
                                  neg2, valid)


verify_tiles.launches = 0
