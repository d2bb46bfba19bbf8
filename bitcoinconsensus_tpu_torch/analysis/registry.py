"""Registry of the port's kernels the prover must prove.

The port's counterpart of `bitcoinconsensus_tpu/analysis/registry.py`. Every
function of the port whose output feeds a consensus verdict is listed with
the input bounds it may assume (the contracts `ops/limbs.py` documents: W2
weak rows for field inputs, canonical rows for exact limbs) and the output
bounds it promises, held against the prover's derived intervals: an
`out_within` failure means the hand bookkeeping understates reality, which
is a fault of the port, not of the prover. Hand-written kernels are listed
by their launch contracts (`analysis/kernel_check.py`).

Entries of the JAX registry the port has no code for yet (`fe_inv`, the
complete adds, `double_scalar_mult_glv`, `mxu.fe_mul_onehot`,
`jax_backend.verify_kernel`) are not registered; ROADMAP.md lists them with
their modules. The reference's `jax_backend.verdict_checksum` is the port's
`cuda.verdict_checksum`, the launch contract and body of
`csrc/verdict_checksum.cu`, and rides the verifier's dispatch as the
epilogue of the checked verify launch, `cuda.verify_tiles_checked`, which
carries the same sums per warp; the device half of the reference's
`parallel/mesh.py::make_sharded_step` (each shard's checksum pair and
failure count) is `cuda.shard_step`, the launch contract and body of
`csrc/shard_step.cu`. The reference's `sha256.compress` and
`sha256.bip340_challenge` are held over the port's plain versions
(`ops/sha256.py`, int64 words masked to 32 bits), whose every intermediate
the prover holds inside int64 and whose words inside [0, 2^32); the five
kernels of `csrc/sha256.cu` are `cuda.sha256_*`, their launch contracts.

To register a kernel:

    KernelSpec("my.kernel", lambda: interval.analyze(fn, specs, "my.kernel",
                                                     in_bounds, out_within),
               heavy=False)

and `python -m bitcoinconsensus_tpu_torch.analysis.lint` picks it up.

The scalar-schedule prover's targets (`analysis/scalar_check.py`) are listed
as `ScheduleSpec`s (`all_schedules`), which `lint --schedule` certifies.
The reference's `curve.double_scalar_mult(_glv)` ladders wait for the
port's modules that hold them; the ladders the port has are its verify
kernel's, certified as `verify_tiles.plain_schedule` and
`verify_tiles.cuda_schedule`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Tuple

import torch

from ..ops import curve as C
from ..ops import limbs as L
from ..ops import sha256 as SH
from ..ops import shard_step as SS
from ..ops import verdict_checksum as VC
from ..ops import verify_tiles as VT
from . import interval, kernel_check

DEFAULT_BATCH = 2  # two lanes: keeps the batch axis without cost
# A full dispatch (128 blocks of 64 lanes), and a ragged width whose last
# block holds 44 lanes.
VERIFY_TILES_WIDTHS = (8192, 4908)


def w2_rows() -> List[Tuple[int, int]]:
    """Weak-representation contract: per-limb [0, W2[i]]."""
    return [(0, int(b)) for b in L.W2]


def canon_rows() -> List[Tuple[int, int]]:
    """Canonical field element: every limb in [0, MASK]."""
    return [(0, L.MASK)] * L.NLIMB


@dataclass
class KernelSpec:
    name: str
    analyze: Callable[[], interval.Report]
    heavy: bool = False
    note: str = ""


def _fe(B: int) -> interval.TensorSpec:
    return interval.TensorSpec((L.NLIMB, B), torch.int32)


def _fn_spec(name, fn, n_args, out_within, note="") -> KernelSpec:
    w2 = w2_rows()
    return KernelSpec(name, lambda: interval.analyze(
        fn, [_fe(DEFAULT_BATCH)] * n_args, name,
        in_bounds={i: w2 for i in range(n_args)}, out_within=out_within),
        note=note)


def vt_specs(B: int) -> List[interval.TensorSpec]:
    """Argument specs of `verify_tiles`'s launch at B lanes (the G table's
    words last)."""
    lanes = [interval.TensorSpec((B,), torch.int32)] * 5
    return ([interval.TensorSpec((B, 4, 32), torch.uint8)] + lanes
            + [interval.TensorSpec((B,), torch.bool),
               interval.TensorSpec(VT.GTAB_SHAPE, torch.int32)])


VT_FLAG_BOUNDS = {1: (0, 1), 2: (-1, 1), 3: (0, 1), 4: (0, 1), 5: (0, 1)}


def _verify_tiles_contract() -> interval.Report:
    rep = interval.Report(name="cuda.verify_tiles")
    for B in VERIFY_TILES_WIDTHS:
        kernel_check.check_contract(VT.VERIFY_TILES_CONTRACT, vt_specs(B),
                                    f"cuda.verify_tiles[{B}]", prove_body=False,
                                    report=rep)
        rep.notes.append(f"contract checked at {B} lanes")
    return rep


def _verify_tiles_body() -> interval.Report:
    B = VT.VERIFY_TILES_CONTRACT.threads
    return kernel_check.check_contract(
        VT.VERIFY_TILES_CONTRACT, vt_specs(B), "cuda.verify_tiles.body",
        in_bounds=VT_FLAG_BOUNDS, out_within=[[(0, 1)] * 2])


# The checked launch's widths: a full dispatch, a ragged one (its last block
# 44 lanes), one lane short of a dispatch (its last warp 31 lanes), and the
# 4 x 16 mesh layout's shard (one block whose second warp lies wholly past
# the lanes and writes nothing).
VERIFY_TILES_CHECKED_WIDTHS = (8192, 4908, 8191, 16)
EPILOGUE_WARP_ROWS = [(0, VT.WARP), (0, VT.CHECKSUM_MOD * VT.WARP), (0, VT.WARP)]


def _verify_tiles_checked() -> interval.Report:
    """`vt_verify_tiles_checked`'s launch contract at every width of
    VERIFY_TILES_CHECKED_WIDTHS (its verdict bytes and each warp's three
    partials written once), and its epilogue's int32 arithmetic proven on a
    full block at the first and at the last block of the widest launch:
    a warp's count and failures inside [0, 32], its weighted sum inside
    [0, 32 * 251]. The lane program's own proof is `cuda.verify_tiles.body`."""
    rep = interval.Report(name="cuda.verify_tiles_checked")
    for B in VERIFY_TILES_CHECKED_WIDTHS:
        kernel_check.check_contract(
            VT.VERIFY_TILES_CHECKED_CONTRACT,
            vt_specs(B) + [interval.TensorSpec((B,), torch.bool)],
            f"cuda.verify_tiles_checked[{B}]", prove_body=False, report=rep)
        rep.notes.append(f"contract checked at {B} lanes")
    threads = VT.VERIFY_TILES_CHECKED_CONTRACT.threads
    lanes = [interval.TensorSpec((threads,), torch.bool)] * 3
    for b in (0, VT.MAX_CHECKED_LANES // threads - 1):
        name = f"cuda.verify_tiles_checked.epilogue[block {b}]"
        outs = interval.prove(
            lambda ok, needs, lv, b=b: VT.epilogue_block((b,), ok, needs, lv), lanes,
            [interval.from_bounds(s, (0, 1)) for s in lanes], rep, name)
        for o in outs or []:
            interval.check_within(rep, f"{name}/out", o, EPILOGUE_WARP_ROWS)
        rep.notes.append(f"epilogue proven inside int32 at block {b}")
    return rep


# One lane, a full dispatch, and the most lanes the kernel takes, where the
# weighted sum comes closest to the int32 edge (251 * 2^23 < 2^31).
VERDICT_CHECKSUM_WIDTHS = (1, 8192, VC.MAX_LANES)


def _verdict_checksum() -> interval.Report:
    rep = interval.Report(name="cuda.verdict_checksum")
    for B in VERDICT_CHECKSUM_WIDTHS:
        # count <= B; weighted <= 251 * B (the largest lane weight)
        kernel_check.check_contract(
            VC.VERDICT_CHECKSUM_CONTRACT,
            [interval.TensorSpec((B,), torch.bool)],
            f"cuda.verdict_checksum[{B}]", in_bounds={0: (0, 1)},
            out_within=[[(0, B), (0, VC.CHECKSUM_MOD * B)]], report=rep)
        rep.notes.append(f"contract and body proven at {B} lanes")
    return rep


# (shards, rows a shard): one row; the chip's mesh layouts (2 x 4,096,
# 4 x 2,048, 8 x 1,024); and one shard at the most rows the kernel takes,
# where the weighted sum comes closest to the int32 edge (251 * 2^23 < 2^31).
SHARD_STEP_LAYOUTS = ((1, 1), (2, 4096), (4, 2048), (8, 1024), (1, SS.MAX_LANES))


def _shard_step() -> interval.Report:
    rep = interval.Report(name="cuda.shard_step")
    for d, rows in SHARD_STEP_LAYOUTS:
        spec = interval.TensorSpec((d, rows), torch.bool)
        # rows of the (3, 1) output window: count <= S; weighted <= 251 * S;
        # failures <= S
        kernel_check.check_contract(
            SS.SHARD_EPILOGUE_CONTRACT, [spec] * 3, f"cuda.shard_step[{d}x{rows}]",
            in_bounds={i: (0, 1) for i in range(3)},
            out_within=[[(0, rows), (0, SS.CHECKSUM_MOD * rows), (0, rows)]],
            report=rep)
        rep.notes.append(f"contract and body proven at {d} x {rows}")
    return rep


M32 = (1 << 32) - 1
# One lane, a ragged width of two blocks, and a full dispatch.
SHA_WIDTHS = (1, 300, 8192)
SHA_BODY_LANES = 3  # the body proofs' width: every lane has the same bounds


def _u8(B: int, n: int = 32) -> interval.TensorSpec:
    return interval.TensorSpec((B, n), torch.uint8)


def _words(rows: int, B: int) -> interval.TensorSpec:
    return interval.TensorSpec((rows, B), torch.uint32)


def _digest(B: int):
    return [[(0, 255)] * B]  # (B, 32) bytes: rows are lanes


# The five kernels of csrc/sha256.cu: (entry, contract, argument specs at B
# lanes, output rows at B lanes).
SHA_CONTRACTS = (
    ("cuda.sha256_compress", SH.COMPRESS_CONTRACT,
     lambda b: [_words(8, b), _words(16, b)], lambda b: [[(0, M32)] * 8]),
    ("cuda.sha256_fixed", SH.fixed_contract(64, double=True),
     lambda b: [_u8(b, 64), _words(8, 1)], _digest),
    ("cuda.sha256_challenge", SH.CHALLENGE_CONTRACT,
     lambda b: [_u8(b)] * 3, _digest),
    ("cuda.sha256_merkle_level", SH.MERKLE_LEVEL_CONTRACT,
     lambda b: [_u8(b)], lambda b: [[(0, 255)] * ((b + 1) // 2)]),
    ("cuda.sha256_merkle_tree", SH.MERKLE_TREE_CONTRACT,
     lambda b: [_u8(b)], lambda b: [[(0, 255)]]),
)


def _sha_contract(name: str) -> interval.Report:
    """A `csrc/sha256.cu` launch contract's windows at every width of
    SHA_WIDTHS (grid, bounds, every output row written once)."""
    _, contract, specs_of, _ = next(c for c in SHA_CONTRACTS if c[0] == name)
    rep = interval.Report(name=name)
    for B in SHA_WIDTHS:
        kernel_check.check_contract(contract, specs_of(B), f"{name}[{B}]",
                                    prove_body=False, report=rep)
        rep.notes.append(f"contract checked at {B} lanes")
    return rep


def _sha_bodies() -> interval.Report:
    """The five contracts' bodies (each kernel's plain version over one
    block's window) proven at SHA_BODY_LANES lanes: every int64
    intermediate inside int64, the words inside [0, 2^32)."""
    rep = interval.Report(name="cuda.sha256.bodies")
    B = SHA_BODY_LANES
    for name, contract, specs_of, rows_of in SHA_CONTRACTS:
        kernel_check.check_contract(contract, specs_of(B), f"{name}[{B}]",
                                    out_within=rows_of(B), report=rep)
        rep.notes.append(f"{name}: body proven at {B} lanes")
    return rep


def _sha_specs() -> List[KernelSpec]:
    B = DEFAULT_BATCH
    return [
        KernelSpec("sha256.compress", lambda: interval.analyze(
            SH.sha256_compress_reference, [_words(8, B), _words(16, B)],
            "sha256.compress", out_within=[[(0, M32)] * 8]),
            note="int64 words masked to 32 bits: every intermediate inside "
                 "int64, the state inside [0, 2^32)"),
        KernelSpec("sha256.bip340_challenge", lambda: interval.analyze(
            SH.bip340_challenge_reference, [_u8(B)] * 3,
            "sha256.bip340_challenge", out_within=_digest(B)), heavy=True,
            note="two compressions from CHALLENGE_MIDSTATE over 96 bytes "
                 "(about 13 s of tracing on one core)"),
        *(KernelSpec(name, lambda name=name: _sha_contract(name),
                     note="launch contract of csrc/sha256.cu at "
                          f"{', '.join(map(str, SHA_WIDTHS))} lanes: one "
                          "thread per lane (the tree: a block a chunk of "
                          f"{SH.TREE_CHUNK} leaves), the ragged edge masked")
          for name, *_ in SHA_CONTRACTS),
        KernelSpec("cuda.sha256.bodies", _sha_bodies, heavy=True,
                   note="the five SHA-256 contracts' bodies proven at "
                        f"{SHA_BODY_LANES} lanes (about 45 s on one core); "
                        "the merkle level's mutated flag and the tree's "
                        "ticket, flag and root are accumulators outside "
                        "the windows"),
    ]


def _specs() -> List[KernelSpec]:
    w2, canon = w2_rows(), canon_rows()
    return [
        _fn_spec("limbs.fe_add", L.fe_add, 2, [w2]),
        _fn_spec("limbs.fe_sub", L.fe_sub, 2, [w2]),
        _fn_spec("limbs.fe_mul", L.fe_mul, 2, [w2],
                 note="schoolbook columns, each below 2^31"),
        _fn_spec("limbs.fe_sqr", L.fe_sqr, 1, [w2]),
        _fn_spec("limbs.fe_canon", L.fe_canon, 1, [canon]),
        _fn_spec("limbs.fe_is_zero", L.fe_is_zero, 1, None),
        _fn_spec("curve.jacobian_double", C.jacobian_double, 3, [w2] * 3),
        KernelSpec("cuda.verify_tiles", _verify_tiles_contract,
                   note="launch contract of csrc/verify_tiles.cu at "
                        f"{' and '.join(map(str, VERIFY_TILES_WIDTHS))} lanes"),
        KernelSpec("cuda.verify_tiles_checked", _verify_tiles_checked,
                   note="launch contract of csrc/verify_tiles.cu's checked "
                        "launch at " + ", ".join(map(str, VERIFY_TILES_CHECKED_WIDTHS))
                        + " lanes: the verdict bytes and the per-warp partials "
                        "written once, the epilogue's sums inside int32"),
        KernelSpec("cuda.verdict_checksum", _verdict_checksum,
                   note="launch contract and int32 body of "
                        "csrc/verdict_checksum.cu at "
                        f"{', '.join(map(str, VERDICT_CHECKSUM_WIDTHS))} lanes: "
                        "one block, both sums inside int32"),
        KernelSpec("cuda.shard_step", _shard_step,
                   note="launch contract and int32 body of csrc/shard_step.cu "
                        "at " + ", ".join(f"{d} x {r}" for d, r in SHARD_STEP_LAYOUTS)
                        + " (shards x rows): one block a shard, the three sums "
                        "inside int32"),
        *_sha_specs(),
        KernelSpec("cuda.verify_tiles.body", _verify_tiles_body, heavy=True,
                   note="interval proof of the plain version "
                        "(verify_tiles_reference, 20x13-bit limbs) on one "
                        "64-lane block; the CUDA kernel's 8x32-bit words are "
                        "held to it bit for bit on the card, not proven"),
    ]


@dataclass
class ScheduleSpec:
    """A scalar-schedule prover target: digit recoders, the GLV split and
    the window ladders. `certify` returns a CertResult whose status is
    THEOREM / VACUOUS / FAIL, fail-closed like the kernels above."""

    name: str
    heavy: bool = False  # heavy: walks a whole verify lane (seconds on CPU)
    note: str = ""

    def certify(self, quick: bool = False):
        from . import scalar_check
        return scalar_check.certify(self.name, quick=quick)


def _schedule_specs() -> List[ScheduleSpec]:
    return [
        ScheduleSpec("scalar._digits",
                     note="4- and 8-bit window recoding: exact bit-slice "
                          "theorem over the aten graph"),
        ScheduleSpec("scalar._digits128",
                     note="recoding of the GLV halves, the signed recoder's "
                          "raw digits and their top window"),
        ScheduleSpec("scalar.bytes_to_limbs",
                     note="byte->limb packing, 32B/20L and 16B/10L; the host "
                          "packers held to it"),
        ScheduleSpec("scalar._signed_digits128",
                     note="signed window recoder: exhaustive carry automaton "
                          "through torch, the .cu's g++ build and vt_recode"),
        ScheduleSpec("glv.split_lambda",
                     note="lattice constants + |k1|,|k2| < 2^128 certificate"),
        ScheduleSpec("sha256.bytes_from_words",
                     note="SHA-256 digest unpack: each byte the exact "
                          "big-endian slice of its word; the message pack "
                          "held too"),
        ScheduleSpec("verify_tiles.plain_schedule", heavy=True,
                     note="verify_tiles_reference: table object flow, signed "
                          "ledger, G rows, differential"),
        ScheduleSpec("verify_tiles.cuda_schedule", heavy=True,
                     note="csrc/verify_tiles.cu lane program through its hooks: "
                          "signed ledger, identity doublings, G rows, source "
                          "checks, differential"),
    ]


def all_schedules(include_heavy: bool = True) -> List[ScheduleSpec]:
    specs = _schedule_specs()
    return specs if include_heavy else [s for s in specs if not s.heavy]


def get_schedule(name: str) -> ScheduleSpec:
    for s in _schedule_specs():
        if s.name == name:
            return s
    raise KeyError(name)


def all_kernels(include_heavy: bool = True) -> List[KernelSpec]:
    specs = _specs()
    return specs if include_heavy else [s for s in specs if not s.heavy]


def get_kernel(name: str) -> KernelSpec:
    for s in _specs():
        if s.name == name:
            return s
    raise KeyError(name)
