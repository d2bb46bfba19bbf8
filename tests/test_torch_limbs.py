"""The port's field arithmetic against `bitcoinconsensus_tpu.ops.limbs`.

Same operands, made from a numpy seed, go through the JAX function and its
torch counterpart; outputs must be identical limb for limb (weak form
included), and after canonicalisation equal to Python-int arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoinconsensus_tpu.ops import limbs as JL
from bitcoinconsensus_tpu_torch.ops import limbs as TL

# The plain version runs thousands of tiny ops; intra-op threads only add
# contention at these widths.
torch.set_num_threads(1)

P = TL.P_INT
W2 = np.asarray(TL.W2, dtype=np.int64)


def _operands(seed: int) -> np.ndarray:
    """(20, 261) int32: 256 seeded weak operands + p-1, p, p+1, 0, max-W2."""
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, W2[:, None] + 1, size=(20, 256))
    specials = [TL.int_to_limbs(v) for v in (P - 1, P, P + 1, 0)] + [W2]
    return np.concatenate(
        [rand, np.stack(specials, axis=1)], axis=1
    ).astype(np.int32)


A = _operands(1)
B = np.roll(_operands(2), 3, axis=1)


def _ints(x: np.ndarray):
    return [TL.limbs_to_int(x[:, i]) for i in range(x.shape[1])]


def _same(jax_fn, torch_fn, *args):
    want = np.asarray(jax.jit(jax_fn)(*args))
    got = torch_fn(*(torch.from_numpy(a) for a in args)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


CASES = {
    "fe_add": (JL.fe_add, TL.fe_add, lambda a, b: a + b),
    "fe_sub": (JL.fe_sub, TL.fe_sub, lambda a, b: a - b),
    "fe_mul": (JL.fe_mul, TL.fe_mul, lambda a, b: a * b),
    "fe_sqr": (lambda a, b: JL.fe_sqr(a), lambda a, b: TL.fe_sqr(a),
               lambda a, b: a * a),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_binary_ops_limb_for_limb(name):
    jfn, tfn, ref = CASES[name]
    got = _same(jfn, tfn, A, B)
    canon = TL.fe_canon(torch.from_numpy(got)).numpy()
    assert _ints(canon) == [ref(a, b) % P for a, b in zip(_ints(A), _ints(B))]


@pytest.mark.parametrize("k", [2, 3, 4, 8])
def test_fe_mul_small_limb_for_limb(k):
    got = _same(lambda a: JL.fe_mul_small(a, k), lambda a: TL.fe_mul_small(a, k), A)
    canon = TL.fe_canon(torch.from_numpy(got)).numpy()
    assert _ints(canon) == [a * k % P for a in _ints(A)]


def test_fe_canon_and_zero_tests():
    canon = _same(JL.fe_canon, TL.fe_canon, A)
    assert _ints(canon) == [a % P for a in _ints(A)]
    assert (canon <= TL.MASK).all()
    zero = _same(JL.fe_is_zero, TL.fe_is_zero, A)
    assert zero.tolist() == [a % P == 0 for a in _ints(A)]
    many = _same(lambda a, b: jnp.stack(JL.fe_is_zero_many((a, b))),
                 lambda a, b: torch.stack(TL.fe_is_zero_many((a, b))), A, B)
    assert many[1].tolist() == [b % P == 0 for b in _ints(B)]
    # The t1 + n canonicalisation of the verify preamble: wider bounds.
    wide = _same(lambda a: JL.fe_canon(a, bounds=[2 * TL.MASK] * 20),
                 lambda a: TL.fe_canon(a, bounds=[2 * TL.MASK] * 20),
                 (A & TL.MASK) * 2)
    assert _ints(wide) == [2 * a % P for a in _ints(A & TL.MASK)]


@pytest.mark.parametrize("nbytes,nlimb", [(32, 20), (16, 10)])
def test_bytes_to_limbs(nbytes, nlimb):
    rng = np.random.default_rng(nbytes)
    u8 = rng.integers(0, 256, size=(64, nbytes), dtype=np.uint8)
    u8[0] = 0xFF
    u8[1] = 0
    got = _same(lambda x: JL.bytes_to_limbs(x, nlimb=nlimb),
                lambda x: TL.bytes_to_limbs(x, nlimb=nlimb), u8)
    assert _ints(got) == [int.from_bytes(r.tobytes(), "little") for r in u8]


# The addition chains are the longest programs here; a narrower slice of
# the operands keeps their compile and run short.
CHAINS = {
    "fe_inv_chain": (JL.fe_inv_chain, TL.fe_inv_chain, lambda a: pow(a, P - 2, P)),
    "fe_sqrt_chain": (JL.fe_sqrt_chain, TL.fe_sqrt_chain,
                      lambda a: pow(a, (P + 1) // 4, P)),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_addition_chains_limb_for_limb(name):
    jfn, tfn, ref = CHAINS[name]
    x = np.ascontiguousarray(A[:, -24:])
    got = _same(jfn, tfn, x)
    canon = TL.fe_canon(torch.from_numpy(got)).numpy()
    assert _ints(canon) == [ref(a % P) for a in _ints(x)]
