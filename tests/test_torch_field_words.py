"""The verify kernel's field layer (`csrc/verify_tiles.cu`), built for the
host from its portable twin, held to Python integers.

The kernel keeps field elements as 8x32-bit words reduced lazily: every
operation returns a value in [0, 2^256) congruent to the exact result mod p,
and only the comparisons canonicalise. Each operation is checked three ways
on seeded operands and the edge values (0, 1, p - 1, p, p + 1, 2^256 - 1,
2^256 - 0x1000003D1, and non-canonical values in [p, 2^256)):

- its words equal `verify_tiles.field_model`, the integer model of the
  kernel's reduction (so the card's PTX carry chains, held to the same model
  by `tests/test_torch_gpu.py`, and this twin give the same words);
- its value is the exact result mod p, and below 2^256;
- canonicalised, it is the exact result's least residue, and the zero test
  says whether that residue is 0.
"""

import ctypes
import os
import shutil
import subprocess
import textwrap

import numpy as np
import pytest
import torch

from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT

P = 2**256 - 0x1000003D1
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HARNESS = textwrap.dedent("""
    #include "{src}"
    extern "C" void vt_host_field(int op, const uint32_t* a, const uint32_t* b,
                                  uint32_t k, uint32_t* out, int n) {{
      for (int i = 0; i < n; i++) {{
        fe r = fe_apply(op, fe_from(a + 8 * i), fe_from(b + 8 * i), k);
        for (int w = 0; w < 8; w++) out[8 * i + w] = r.v[w];
      }}
    }}
""")

EDGE = [0, 1, P - 1, P, P + 1, 2**256 - 1, 2**256 - 0x1000003D1,
        P + 0x3D0, 2**256 - 2, 2**255, 0x1000003D1, 2**32 - 1]


@pytest.fixture(scope="module")
def host_field(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel's field layer")
    d = tmp_path_factory.mktemp("field")
    src = os.path.join(REPO, "bitcoinconsensus_tpu_torch", "csrc", "verify_tiles.cu")
    harness = d / "field.cpp"
    harness.write_text(_HARNESS.format(src=src))
    lib_path = d / "field.so"
    subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-o", str(lib_path),
                    str(harness)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))

    def run(op: str, a, b, k: int = 0):
        aw = np.ascontiguousarray(VT.ints_to_words(a))
        bw = np.ascontiguousarray(VT.ints_to_words(b))
        out = np.zeros_like(aw)
        lib.vt_host_field(VT.FIELD_OPS.index(op), ctypes.c_void_p(aw.ctypes.data),
                          ctypes.c_void_p(bw.ctypes.data), ctypes.c_uint32(k),
                          ctypes.c_void_p(out.ctypes.data), len(a))
        return VT.words_to_ints(out)

    return run


def _operands(seed: int):
    """Pairs: every edge value against every edge value, then seeded values
    over the whole of [0, 2^256) (so about 1 in 2^32 non-canonical) and
    seeded non-canonical values in [p, 2^256)."""
    rng = np.random.default_rng(seed)
    a = [x for x in EDGE for _ in EDGE]
    b = [y for _ in EDGE for y in EDGE]
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(256)]
    lazy = [P + int(rng.integers(0, 0x1000003D1)) for _ in range(64)]
    a += rand + lazy + rand[::-1][:64]
    b += rand[::-1] + lazy[::-1] + lazy
    return a, b


_EXACT = {
    "mul": lambda a, b, k: a * b,
    "sqr": lambda a, b, k: a * a,
    "add": lambda a, b, k: a + b,
    "sub": lambda a, b, k: a - b,
    "mul_int": lambda a, b, k: a * k,
}


@pytest.mark.parametrize("op,k", [("mul", 0), ("sqr", 0), ("add", 0), ("sub", 0),
                                  ("mul_int", 2), ("mul_int", 3), ("mul_int", 8)])
def test_field_op_matches_integers_mod_p(host_field, op, k):
    a, b = _operands(len(op) + k)
    got = host_field(op, a, b, k)
    for x, y, r in zip(a, b, got):
        assert 0 <= r < 2**256
        assert (r - _EXACT[op](x, y, k)) % P == 0, (op, hex(x), hex(y))
        assert r == VT.field_model(op, x, y, k), (op, hex(x), hex(y))


def test_canonical_compare_matches_integers(host_field):
    a, b = _operands(7)
    vals = a + [(x * y) % P for x, y in zip(a[:64], b[:64])]
    canon = host_field("canon", vals, vals)
    zero = host_field("is_zero", vals, vals)
    for v, c, z in zip(vals, canon, zero):
        assert c == v % P
        assert z == int(v % P == 0)
    # The lazy results of every op canonicalise to the least residue.
    for op in ("mul", "add", "sub"):
        lazy = host_field(op, a, b)
        for x, y, c in zip(a, b, host_field("canon", lazy, lazy)):
            assert c == _EXACT[op](x, y, 0) % P


def test_field_op_plain_version_is_the_model():
    a, b = _operands(3)
    aw = torch.from_numpy(VT.ints_to_words(a[:32]).copy())
    bw = torch.from_numpy(VT.ints_to_words(b[:32]).copy())
    got = VT.words_to_ints(VT.field_op("sub", aw, bw).numpy())
    assert got == [VT.field_model("sub", x, y) for x, y in zip(a[:32], b[:32])]
    with pytest.raises(ValueError):
        VT.field_op("div", aw, bw)


def test_square_gives_the_words_of_the_product(host_field):
    """The square takes each cross product once, doubles the cross sum by
    one-bit shifts and adds the diagonal; its words must be the multiply's
    of a by itself, on values whose cross sums carry into every word's top
    bit (all-ones words, alternating patterns) as well as the edge and
    seeded ones."""
    a, _ = _operands(11)
    patterns = [int("AAAAAAAA" * 8, 16), int("55555555" * 8, 16),
                int("80000000" * 8, 16), int("FFFFFFFF00000000" * 4, 16),
                int("00000000FFFFFFFF" * 4, 16)]
    vals = a + patterns
    assert host_field("sqr", vals, vals) == host_field("mul", vals, vals)
