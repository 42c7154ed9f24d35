"""Port polyphase ADA (diagan_tpu_torch.ops.ada_phase and the polyphase form
of diagan_tpu_torch.models.ada) against the JAX package.

  - the two-phase warp against the JAX oracle `_gather2_xla` on the
    geometries of tests/test_ada_phase.py, at 1e-6, and against the Pallas
    kernel in interpret mode at that file's tolerances; its adjoint against
    jax.vjp of the oracle;
  - `apply_affine(polyphase=True)` against the JAX function on JAX-drawn
    matrices, with and without pad buckets (both packages ignore them under
    polyphase), at 1e-5 at 16 px and 3e-5 at 32 px (TOL_32 says why), and
    its image gradient against jax.grad at 32 px;
  - the identity transform reconstructs; polyphase agrees with the
    interleaved form; the opt-in is off on the CPU and without the variable.

The port's planes are exactly (N, C, s2/2, s2): it is fed the logical region
of the JAX planes, which are padded to the TPU's tiling. Layouts go NHWC <->
NCHW at the boundary.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_ada_phase import CASES, _phase_planes  # noqa: E402

from diagan_tpu.models import ada as J  # noqa: E402
from diagan_tpu.ops import ada_phase as JP  # noqa: E402
from diagan_tpu_torch import ops as tops  # noqa: E402
from diagan_tpu_torch.models import ada as T  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
# At 32 px the warp reads 2x-buffer coordinates up to ~180 px, where an ulp
# of the inverted matrix (torch and JAX invert with other LAPACK calls) or of
# the coefficient arithmetic (XLA contracts it into FMAs under jit) moves a
# read by ~1e-5 px: JAX's own jitted and eager results differ by 1.1e-5
# there, and the two packages' interleaved forms by 1.4e-5 (which
# test_torch_port_ada.py holds at 16 px).
TOL_32 = dict(rtol=1e-5, atol=3e-5)
# jitted: eager JAX is slow on the CPU
jax_apply_affine = jax.jit(J.apply_affine, static_argnames=("polyphase", "pad_buckets"))
N, C, S, WIN = 2, 3, 96, 60  # tests/test_ada_phase.py's sizes


def _port_planes(v0, v1, s2):
    """The logical (s2/2, s2) region of the JAX planes, as torch tensors."""
    return tuple(torch.from_numpy(np.array(v[:, :, :s2 // 2, :s2])) for v in (v0, v1))


def _nchw(ys):
    return [np.asarray(y).transpose(0, 3, 1, 2) for y in ys]


def _coef(case, n=N):
    return np.stack([CASES[case]] * n).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather2_matches_xla_oracle(case):
    """Exact bilinear with no window, as the oracle. The oracle runs eagerly:
    under jit XLA contracts the coordinate arithmetic into FMAs, which moves
    a coordinate by an ulp (~1e-5 px at s2 = 192)."""
    v0, v1, s2 = _phase_planes(np.random.default_rng(5), N, C, S)
    coef = _coef(case)
    want = _nchw(JP._gather2_xla(v0, v1, jnp.asarray(coef), WIN, s2))
    got = tops.affine_gather_2phase(*_port_planes(v0, v1, s2), torch.from_numpy(coef), WIN, s2)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.shape == (N, C, WIN // 2, WIN // 2) and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)


def test_gather2_matches_pallas_interpret():
    v0, v1, s2 = _phase_planes(np.random.default_rng(5), N, C, S)
    coef = _coef("rot_scale")
    want = _nchw(JP.affine_gather_2phase(v0, v1, jnp.asarray(coef), WIN, s2, backend="pallas",
                                         interpret=True))
    got = tops.affine_gather_2phase(*_port_planes(v0, v1, s2), torch.from_numpy(coef), WIN, s2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-3, atol=1e-4)


@pytest.mark.parametrize("case", ["identity", "rot_scale", "clipped"])
def test_scatter2_matches_jax_vjp(case):
    """The adjoint (through autograd and alone) against jax.vjp of the
    oracle, at tests/test_ada_phase.py's backward tolerances."""
    rng = np.random.default_rng(9)
    v0, v1, s2 = _phase_planes(rng, N, 2, S)
    coef = _coef(case)
    w = [rng.normal(size=(N, WIN // 2, WIN // 2, 2)).astype(np.float32) for _ in range(4)]
    zeros = jnp.zeros((N, 2, s2 // 2, s2), jnp.float32)
    _, vjp = jax.vjp(lambda a, b: JP._gather2_xla(a, b, jnp.asarray(coef), WIN, s2), zeros, zeros)
    want = [np.asarray(d) for d in vjp(tuple(jnp.asarray(x) for x in w))]
    pv = [p.requires_grad_(True) for p in _port_planes(v0, v1, s2)]
    ys = tops.affine_gather_2phase(*pv, torch.from_numpy(coef), WIN, s2)
    gs = [torch.from_numpy(x.transpose(0, 3, 1, 2).copy()) for x in w]
    got = torch.autograd.grad(sum((y * g).sum() for y, g in zip(ys, gs)), pv)
    alone = tops.affine_scatter2(gs, torch.from_numpy(coef), s2)
    atol = 2e-4 if case == "clipped" else 2e-5
    for g, a, ww in zip(got, alone, want):
        np.testing.assert_allclose(g.numpy(), ww, rtol=1e-4, atol=atol)
        torch.testing.assert_close(a, g, rtol=0, atol=0)


def _images(n, h, seed):
    return np.tanh(np.random.default_rng(seed).standard_normal((n, h, h, 3))).astype(np.float32)


def _jax_affine(n, p, h, seed):
    fn = jax.jit(J.sample_affine_matrices, static_argnums=(1, 2, 3, 4))
    return np.array(fn(jax.random.key(seed), n, p, h, h))


@pytest.mark.parametrize("pad_buckets", [None, (0.25, 0.5)])
@pytest.mark.parametrize("h", [16, 32])
def test_apply_affine_polyphase_matches_jax(h, pad_buckets):
    x, G = _images(3, h, h), _jax_affine(3, 0.9, h, h)
    want = np.asarray(jax_apply_affine(jnp.asarray(x), jnp.asarray(G), polyphase=True,
                                       pad_buckets=pad_buckets))
    got = T.apply_affine(torch.from_numpy(x), torch.from_numpy(G), polyphase=True,
                         pad_buckets=pad_buckets).numpy()
    np.testing.assert_allclose(got, want, **(TOL if h == 16 else TOL_32))
    if pad_buckets:  # ignored under polyphase: the largest pad, as without buckets
        plain = T.apply_affine(torch.from_numpy(x), torch.from_numpy(G), polyphase=True).numpy()
        np.testing.assert_array_equal(got, plain)


def test_polyphase_agrees_with_interleaved_and_identity_reconstructs():
    """The two forms of one resample, at tests/test_ada_phase.py's tolerance;
    sym6 is orthonormal, so the identity gives the input back."""
    h = 32
    x = torch.from_numpy(_images(4, h, 11))
    G = torch.from_numpy(_jax_affine(4, 0.9, h, 2))
    torch.testing.assert_close(T.apply_affine(x, G, polyphase=True),
                               T.apply_affine(x, G, polyphase=False), rtol=2e-4, atol=2e-5)
    eye = torch.eye(3).expand(4, 3, 3)
    torch.testing.assert_close(T.apply_affine(x, eye, polyphase=True), x, **TOL)


def test_apply_affine_polyphase_image_grad_matches_jax():
    h = 32
    x, G = _images(2, h, 17), _jax_affine(2, 0.8, h, 4)
    w = np.random.default_rng(18).standard_normal((2, h, h, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(
        J.apply_affine(a, jnp.asarray(G), polyphase=True) * w)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(
        (T.apply_affine(xt, torch.from_numpy(G), polyphase=True) * torch.from_numpy(w)).sum(), xt)
    np.testing.assert_allclose(got.numpy(), want, **TOL_32)


def test_polyphase_opt_in_only_on_cuda_and_with_the_variable(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    monkeypatch.delenv("DIAGAN_TPU_ADA_POLYPHASE", raising=False)
    assert not T._polyphase_auto(cpu) and not T._polyphase_auto(cuda)
    monkeypatch.setenv("DIAGAN_TPU_ADA_POLYPHASE", "1")
    assert not T._polyphase_auto(cpu) and T._polyphase_auto(cuda)
    # on the CPU auto stays interleaved: buckets are honoured, nothing polyphase runs
    calls = []
    monkeypatch.setattr(T, "_polyphase_resample", lambda *a: calls.append(a))
    x, G = torch.from_numpy(_images(2, 16, 3)), torch.from_numpy(_jax_affine(2, 0.5, 16, 3))
    assert T.augment(x, 0.5, G, torch.eye(4).expand(2, 4, 4)).shape == x.shape
    assert calls == []
