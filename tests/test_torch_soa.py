"""Each SoA (ops/soa.py) and quaternion (ops/quat.py) function of the port
against the JAX package's, on the same random float32 inputs.

Both evaluate the same float32 operations in the same order; transcendental
functions (sin, cos, tanh, sqrt) may round differently by an ulp between
XLA and PyTorch, so values agree to rtol 1e-5 / atol 1e-6 (1e-4 relative
for the 6x6 Cholesky inverse, whose condition number amplifies rounding)."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu.ops import quat as JQ
from rapid_locomotion_rl_tpu.ops import soa as JS
from rapid_locomotion_rl_tpu_torch.ops import quat as TQ
from rapid_locomotion_rl_tpu_torch.ops import soa as TS

N = 64


def _draw(kind, rng):
    """A nested tuple of numpy [N] float32 arrays of the given kind."""
    a = lambda lo=-1.0, hi=1.0: rng.uniform(lo, hi, N).astype(np.float32)  # noqa: E731
    if kind == "s":
        return a()
    if kind == "pos":
        return a(0.5, 2.0)
    if kind == "v3":
        return tuple(a() for _ in range(3))
    if kind == "m3":
        return tuple(tuple(a() for _ in range(3)) for _ in range(3))
    if kind == "q":
        q = rng.normal(size=(4, N)).astype(np.float32)
        q /= np.linalg.norm(q, axis=0, keepdims=True)
        return tuple(q)
    if kind == "sv":
        return (_draw("v3", rng), _draw("v3", rng))
    if kind in ("sm", "spd"):
        M = rng.uniform(-1, 1, (N, 6, 6)).astype(np.float32)
        if kind == "spd":
            M = (M @ np.swapaxes(M, 1, 2) + 3.0 * np.eye(6)).astype(np.float32)
        return tuple(tuple(tuple(tuple(M[:, bi * 3 + i, bj * 3 + j]
                                       for j in range(3)) for i in range(3))
                           for bj in range(2)) for bi in range(2))
    raise KeyError(kind)


def _map(f, x):
    if isinstance(x, (tuple, list)):
        return type(x)(_map(f, y) for y in x) if isinstance(x, tuple) \
            else [_map(f, y) for y in x]
    return f(x)


def _leaves(x):
    if x is None:   # chol6's upper triangle
        return []
    if isinstance(x, (tuple, list)):
        return [leaf for y in x for leaf in _leaves(y)]
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)]


SOA_CASES = [
    ("v3_add", ["v3", "v3"]), ("v3_sub", ["v3", "v3"]),
    ("v3_scale", ["v3", "s"]), ("v3_dot", ["v3", "v3"]),
    ("v3_cross", ["v3", "v3"]), ("v3_norm", ["v3"]),
    ("v3_zeros_like", ["s"]), ("m3_identity_like", ["s"]),
    ("m3_t", ["m3"]), ("m3_mul", ["m3", "m3"]), ("m3_vec", ["m3", "v3"]),
    ("m3_tvec", ["m3", "v3"]), ("m3_add", ["m3", "m3"]),
    ("m3_sub", ["m3", "m3"]), ("m3_scale", ["m3", "s"]),
    ("m3_outer", ["v3", "v3"]), ("m3_skew", ["v3"]),
    ("m3_solve", ["m3", "v3"]), ("m3_axis_angle", ["v3", "s"]),
    ("quat_rotate", ["q", "v3"]), ("quat_rotate_inv", ["q", "v3"]),
    ("quat_to_m3", ["q"]), ("quat_mul", ["q", "q"]),
    ("quat_normalize", ["q"]), ("sv_add", ["sv", "sv"]),
    ("sv_sub", ["sv", "sv"]), ("sv_scale", ["sv", "s"]),
    ("sv_dot", ["sv", "sv"]), ("sm_vec", ["sm", "sv"]),
    ("sm_add", ["sm", "sm"]), ("sm_scale", ["sm", "s"]),
    ("sm_outer", ["sv", "sv"]), ("spatial_inertia", ["pos", "v3", "m3"]),
    ("crm", ["sv", "sv"]), ("crf", ["sv", "sv"]),
    ("xform_motion", ["m3", "v3", "sv"]),
    ("xform_force_to_parent", ["m3", "v3", "sv"]),
    ("xform_inertia_to_parent", ["m3", "v3", "sm"]),
    ("xform_phi_to_child", ["m3", "v3", "sm"]),
    ("chol6", ["spd"]), ("solve_psd6", ["spd", "sv"]), ("inv_psd6", ["spd"]),
]


@pytest.mark.parametrize("name,kinds", SOA_CASES, ids=[c[0] for c in SOA_CASES])
def test_soa_function_matches_jax(name, kinds):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    args = [_draw(k, rng) for k in kinds]
    ref = getattr(JS, name)(*_map(jnp.asarray, args))
    out = getattr(TS, name)(*_map(torch.tensor, args))
    rtol = 1e-4 if name == "inv_psd6" else 1e-5
    ra, oa = _leaves(ref), _leaves(out)
    assert len(ra) == len(oa)
    for r, o in zip(ra, oa):
        np.testing.assert_allclose(o, r, rtol=rtol, atol=1e-6)


def test_soa_quat_integrate_matches_jax():
    rng = np.random.default_rng(3)
    q, w = _draw("q", rng), _draw("v3", rng)
    ref = JS.quat_integrate(_map(jnp.asarray, q), _map(jnp.asarray, w), 0.0025)
    out = TS.quat_integrate(_map(torch.tensor, q), _map(torch.tensor, w),
                            0.0025)
    for r, o in zip(_leaves(ref), _leaves(out)):
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-6)


def test_soa_helpers_keep_floats_floats():
    """Model constants stay python floats; two floats give a float32 0-d
    tensor like jnp.maximum of two floats gives a float32 array."""
    assert TS.sqrt(4.0) == 2.0 and TS.sin(0.0) == 0.0 and TS.cos(0.0) == 1.0
    m = TS.maximum(0.5, 1e-9)
    assert m.dtype == torch.float32 and float(m) == np.float32(0.5)
    t = torch.tensor([-1.0, 2.0])
    assert torch.equal(TS.maximum(t, 0.0), torch.tensor([0.0, 2.0]))
    assert torch.equal(TS.minimum(0.0, t), torch.tensor([-1.0, 0.0]))


QUAT_CASES = [
    ("normalize", ["q4"]), ("quat_mul", ["q4", "q4"]),
    ("quat_conjugate", ["q4"]), ("quat_rotate", ["q4", "v"]),
    ("quat_rotate_inverse", ["q4", "v"]), ("quat_to_rotmat", ["q4"]),
    ("quat_from_axis_angle", ["v", "a"]), ("quat_from_euler_xyz", ["a", "a", "a"]),
    ("yaw_from_quat", ["q4"]), ("quat_apply_yaw", ["q4", "v"]),
    ("wrap_to_pi", ["big"]), ("quat_integrate", ["q4", "v", "dt"]),
]


@pytest.mark.parametrize("name,kinds", QUAT_CASES,
                         ids=[c[0] for c in QUAT_CASES])
def test_quat_function_matches_jax(name, kinds):
    rng = np.random.default_rng(zlib.crc32(name.encode()))

    def draw(k):
        if k == "q4":
            q = rng.normal(size=(N, 4)).astype(np.float32)
            return q / np.linalg.norm(q, axis=-1, keepdims=True)
        if k == "v":
            return rng.uniform(-1, 1, (N, 3)).astype(np.float32)
        if k == "a":
            return rng.uniform(-3, 3, N).astype(np.float32)
        if k == "big":
            return rng.uniform(-20, 20, N).astype(np.float32)
        return 0.005

    args = [draw(k) for k in kinds]
    ref = getattr(JQ, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                              else a for a in args])
    out = getattr(TQ, name)(*[torch.tensor(a) if isinstance(a, np.ndarray)
                              else a for a in args])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=2e-6)
