"""The port's group law, digits, G table and GLV split against the JAX
package (`ops/curve.py`, `ops/_gtable8.npz`, `crypto/glv.py`).

Points are built with the host oracle at B = 16 lanes covering generic
additions, a left operand at infinity, equal points (the flagged
`needs_dbl` case) and negated points (cancellation to infinity); every
output must be identical limb for limb.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoinconsensus_tpu.crypto import glv as JG
from bitcoinconsensus_tpu.crypto import secp_host as H
from bitcoinconsensus_tpu.ops import curve as JC
from bitcoinconsensus_tpu_torch.crypto import glv as TG
from bitcoinconsensus_tpu_torch.ops import curve as TC
from bitcoinconsensus_tpu_torch.ops import limbs as TL

# The plain version runs thousands of tiny ops; intra-op threads only add
# contention at these widths.
torch.set_num_threads(1)

P, N = H.P, H.N
LANES = 16


def _limbs(vals):
    return np.stack([TL.int_to_limbs(v % P) for v in vals], axis=1)


def _jac(pt, z):
    x, y = pt
    return x * z * z % P, y * z * z * z % P, z


def _panel():
    """Left operands R (Jacobian), right operands Q (affine and Jacobian),
    and the left-infinity mask, lane by lane."""
    rng = np.random.default_rng(7)
    R, Qa, Qj, inf1 = [], [], [], []
    for i in range(LANES):
        k1 = int(rng.integers(1, 2**62)) * 0x9E3779B97F4A7C15 % N
        k2 = int(rng.integers(1, 2**62)) * 0xC2B2AE3D27D4EB4F % N
        z1 = int(rng.integers(2, 2**62)) ** 4 % P
        z2 = int(rng.integers(2, 2**62)) ** 4 % P
        p1 = H.G.mul(k1).to_affine()
        if i % 4 == 1:  # equal points
            q = p1
        elif i % 4 == 2:  # negated points
            q = (p1[0], P - p1[1])
        else:
            q = H.G.mul(k2).to_affine()
        R.append(_jac(p1, z1))
        Qa.append(q)
        Qj.append(_jac(q, z2))
        inf1.append(i % 4 == 3 and i > 8)
    cols = lambda pts, j: _limbs([p[j] for p in pts])  # noqa: E731
    return ([cols(R, j) for j in range(3)], [cols(Qa, j) for j in range(2)],
            [cols(Qj, j) for j in range(3)], np.asarray(inf1))


(RX, RY, RZ), (QX, QY), (QJX, QJY, QJZ), INF1 = _panel()
INF2 = np.zeros(LANES, dtype=bool)
INF2[5] = True


def _compare(jax_fn, torch_fn, *args):
    want = jax_fn(*(jnp.asarray(a) for a in args))
    got = torch_fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return [g.numpy() for g in got]


def test_jacobian_double():
    X, Y, Z = _compare(JC.jacobian_double, TC.jacobian_double, RX, RY, RZ)
    # Weak output: its affine value is the doubled point.
    for i in (0, 4):
        z = TL.limbs_to_int(Z[:, i]) % P
        zi = pow(z, P - 2, P)
        x = TL.limbs_to_int(X[:, i]) * zi * zi % P
        p1 = H.PointJ(*(TL.limbs_to_int(c[:, i]) for c in (RX, RY, RZ)))
        assert x == p1.double().to_affine()[0]


def test_jacobian_madd_flagged():
    out = _compare(
        lambda *a: JC.jacobian_madd_flagged(*a[:5], inf1=a[5]),
        lambda *a: TC.jacobian_madd_flagged(*a[:5], inf1=a[5]),
        RX, RY, RZ, QX, QY, INF1,
    )
    inf, needs = out[3], out[4]
    lanes = np.arange(LANES)
    assert needs.tolist() == ((lanes % 4 == 1) & ~INF1).tolist()
    assert inf.tolist() == ((lanes % 4 == 2) & ~INF1).tolist()
    # Statically finite left operand (inf1=False) takes its own path.
    _compare(lambda *a: JC.jacobian_madd_flagged(*a, inf1=False),
             lambda *a: TC.jacobian_madd_flagged(*a, inf1=False),
             RX, RY, RZ, QX, QY)


def test_jacobian_madd_flagged_ratio():
    out = _compare(
        lambda *a: JC.jacobian_madd_flagged_ratio(*a, inf1=False),
        lambda *a: TC.jacobian_madd_flagged_ratio(*a, inf1=False),
        RX, RY, RZ, QX, QY,
    )
    assert len(out) == 6


def test_jacobian_add_flagged():
    out = _compare(
        lambda *a: JC.jacobian_add_flagged(*a[:6], a[6], inf1=a[7]),
        lambda *a: TC.jacobian_add_flagged(*a[:6], a[6], inf1=a[7]),
        RX, RY, RZ, QJX, QJY, QJZ, INF2, INF1,
    )
    needs = out[4]
    lanes = np.arange(LANES)
    assert needs.tolist() == ((lanes % 4 == 1) & ~INF1 & ~INF2).tolist()


def test_digits_exact():
    rng = np.random.default_rng(11)
    vals = [int(v) for v in rng.integers(0, 2**63, size=12)]
    a = _limbs([v * 0xD1B54A32D192ED03 ** 3 % N for v in vals] + [N - 1, 0])
    b = _limbs([v * 0x94D049BB133111EB ** 2 % 2**128 for v in vals]
               + [2**128 - 1, 0])[:10]
    for jax_fn, torch_fn, x in (
        (lambda x: JC._digits(x, 8, 32), lambda x: TC._digits(x, 8, 32), a),
        (lambda x: JC._digits(x, 4, 64), lambda x: TC._digits(x, 4, 64), a),
        (JC._digits128, TC._digits128, b),
        (lambda x: JC._digits128(x, 26, 5), lambda x: TC._digits128(x, 26, 5), b),
    ):
        want = np.asarray(jax.jit(jax_fn)(x))
        got = torch_fn(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)


def test_g_table_equals_artifact():
    path = os.path.join(os.path.dirname(JC.__file__), "_gtable8.npz")
    data = np.load(path)
    gx, gy = TC.g_table("cpu")
    np.testing.assert_array_equal(gx.numpy(), data["gx"])
    np.testing.assert_array_equal(gy.numpy(), data["gy"])


def _glv_panel():
    lam = JG.LAMBDA
    return [0, 1, 2, N - 1, lam, (N - lam) % N, (1 << 128) - 1, 1 << 128,
            N // 2, N // 2 + 1, lam - 1, lam + 1]


@pytest.mark.parametrize("which", ["boundary_panel", "seeded"])
def test_split_lambda_matches(which):
    if which == "boundary_panel":
        ks = _glv_panel()
        assert len(ks) == 12
    else:
        rng = np.random.default_rng(19)
        ks = [int.from_bytes(rng.bytes(32), "big") for _ in range(1000)]
    assert TG.LAMBDA == JG.LAMBDA == JC.LAMBDA
    for k in ks:
        got = TG.split_lambda(k)
        assert got == JG.split_lambda(k), k
        a1, n1, a2, n2 = got
        k1 = -a1 if n1 else a1
        k2 = -a2 if n2 else a2
        assert (k1 + TG.LAMBDA * k2 - k) % N == 0


def test_split_lambda_range_error_is_typed():
    assert issubclass(TG.SplitRangeError, ValueError)
    err = TG.SplitRangeError(5, 1 << 128, 0)
    assert "2^128" in str(err)


def test_jnp_constants_agree():
    assert TC.G_X == JC.G_X and TC.G_Y == JC.G_Y and TC.BETA == JC.BETA
    assert np.array_equal(np.asarray(jnp.asarray(JC._BETA_LIMBS)), TC._BETA_LIMBS)
