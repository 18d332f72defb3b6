"""The port's DeepSVRP local step (K3's plain version, `ops.prox_update_tree`,
`rounds.local_prox_gd_tree`) against `repro`, on the CPU.

Inputs are made from a seed with numpy and handed to both packages.  The
reference runs both of its paths: the jnp leaf-wise update and the Pallas
kernel in interpret mode over its per-dtype concatenation.  Tolerances are
the reference's (tests/test_kernels_prox.py:146-177): float32 rtol 1e-6,
bfloat16 atol = rtol = 2e-2, float64 rtol 1e-12.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.rounds import local_prox_gd_tree as ref_local_prox_gd_tree  # noqa: E402
from repro.kernels import ops as kops  # noqa: E402
from repro_torch.core.rounds import local_prox_gd_tree  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.prox_update import prox_update, prox_update_plain  # noqa: E402
from repro_torch.utils.tree import tree_map  # noqa: E402

TOL = {"float32": dict(rtol=1e-6, atol=1e-7), "bfloat16": dict(rtol=2e-2, atol=2e-2),
       "float64": dict(rtol=1e-12, atol=0.0)}


@pytest.fixture
def pallas(request):
    """The reference's kernel switch, restored afterwards."""
    saved = (kops._USE_PALLAS, kops._PALLAS_INTERPRET)
    kops.use_pallas(request.param, interpret=True)
    yield request.param
    kops.use_pallas(*saved)


def _mixed_tree(seed):
    """The reference test's tree: float32 leaves, a bf16 leaf, float32 grads
    against every leaf (also the bf16 one), z = y - 0.25; numpy in float32."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 37), "b": (129,), "c": (4, 5), "d": (2, 2, 2)}
    dtypes = {"a": "float32", "b": "float32", "c": "bfloat16", "d": "float32"}
    y = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    y["c"] = np.array(jnp.asarray(y["c"], jnp.bfloat16).astype(jnp.float32))  # bf16 values
    g = {k: (v * 0.3).astype(np.float32) for k, v in y.items()}
    z = {k: v - 0.25 for k, v in y.items()}
    return y, g, z, dtypes


def _np(x):
    """numpy of a torch or jax array; bf16 as float32, which holds it exactly."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


@pytest.mark.parametrize("pallas", [False, True], indirect=True, ids=["jnp", "pallas"])
def test_prox_update_tree_matches_reference(pallas):
    y, g, z, dtypes = _mixed_tree(0)
    jy = {k: jnp.asarray(v, dtypes[k]) for k, v in y.items()}
    jz = {k: jnp.asarray(v, dtypes[k]) for k, v in z.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    want = kops.prox_update_tree(jy, jg, jz, 0.1, 2.0)
    ty = {k: torch.from_numpy(v).to(getattr(torch, dtypes[k])) for k, v in y.items()}
    tz = {k: torch.from_numpy(v).to(getattr(torch, dtypes[k])) for k, v in z.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    got = ops.prox_update_tree(ty, tg, tz, 0.1, 2.0)
    assert prox_update.launches == 0  # the CPU runs the plain version
    for k in y:
        assert got[k].shape == ty[k].shape and got[k].dtype == ty[k].dtype, k
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **TOL[dtypes[k]], err_msg=k)
        leaf = prox_update_plain(ty[k], tg[k], tz[k], 0.1, 2.0)
        np.testing.assert_allclose(_np(leaf), _np(want[k]), **TOL[dtypes[k]], err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_prox_update_matches_reference(dtype):
    """One tensor of each dtype, lr and inv_eta rounded to it, as
    `jnp.asarray(lr, dtype)` and the jnp path's weak-typed floats round them."""
    rng = np.random.default_rng(1)
    y, g, z = (rng.standard_normal(300).astype(np.float32) for _ in range(3))
    want = kops.prox_update(jnp.asarray(y, dtype), jnp.asarray(g, dtype), jnp.asarray(z, dtype),
                            0.1, 3.0)
    tdt = getattr(torch, dtype)
    got = prox_update(torch.from_numpy(y).to(tdt), torch.from_numpy(g).to(tdt),
                      torch.from_numpy(z).to(tdt), 0.1, 3.0)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def _toy_quadratic(seed, dtype):
    """A tree of elementwise quadratics f(y) = sum a y^2 / 2 - b y: numpy
    leaves (a, b, y0, z, g0)."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (5, 7), "layers": {"u": (2, 3, 4), "v": (11,)}}

    def tree(fn, s=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in s.items()}

    mk = lambda lo: tree(lambda s: (lo + rng.random(s)).astype(dtype))  # noqa: E731
    return mk(0.5), mk(-0.5), mk(-0.5), mk(-0.5), mk(-0.5)


def _assert_tree_close(got, want, tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_close(got[k], want[k], tol)
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("steps", [0, 3])
def test_local_prox_gd_tree_matches_reference(dtype, steps):
    """K = 0 returns (y0, g0); K = 3 steps on a toy quadratic tree."""
    a, b, y0, z, g0 = _toy_quadratic(2, dtype)
    j = lambda tr: jax.tree.map(jnp.asarray, tr)  # noqa: E731
    ja, jb = j(a), j(b)
    want_y, want_g = ref_local_prox_gd_tree(
        lambda y: jax.tree.map(lambda aa, bb, yy: aa * yy - bb, ja, jb, y), j(z), j(y0),
        0.05, 1 / 0.7, steps, g0=j(g0))
    t = lambda tr: tree_map(torch.from_numpy, tr)  # noqa: E731
    ta, tb = t(a), t(b)
    got_y, got_g = local_prox_gd_tree(
        lambda y: tree_map(lambda aa, bb, yy: aa * yy - bb, ta, tb, y), t(z), t(y0),
        0.05, 1 / 0.7, steps, g0=t(g0))
    _assert_tree_close(got_y, want_y, TOL[dtype])
    _assert_tree_close(got_g, want_g, TOL[dtype])


@pytest.mark.parametrize("op", ["add", "sub", "scale", "axpy", "zeros_like", "where", "cast"])
def test_tree_helpers_match_reference(op):
    """`repro_torch.utils.tree` against `repro.utils.tree` on a nested tree."""
    from repro.utils import tree as jt
    from repro_torch.utils import tree as tt

    a, b, _, _, _ = _toy_quadratic(3, "float32")
    ja, jb = jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b)
    ta, tb = tree_map(torch.from_numpy, a), tree_map(torch.from_numpy, b)
    calls = {
        "add": (lambda m, x, y: m.tree_add(x, y)), "sub": (lambda m, x, y: m.tree_sub(x, y)),
        "scale": (lambda m, x, y: m.tree_scale(x, 0.3)),
        "axpy": (lambda m, x, y: m.tree_axpy(-0.7, x, y)),
        "zeros_like": (lambda m, x, y: m.tree_zeros_like(x)),
        "where": (lambda m, x, y: m.tree_where(False, x, y)),
        "cast": (lambda m, x, y: m.tree_cast(x, jnp.bfloat16 if m is jt else torch.bfloat16)),
    }
    got, want = calls[op](tt, ta, tb), calls[op](jt, ja, jb)
    _assert_tree_close(got, want, TOL["float32"] if op != "cast" else TOL["bfloat16"])
