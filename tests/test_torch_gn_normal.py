"""The refine's normal equations on the CPU: ``gn_normal_plain``, the
reference ``csrc/gn_normal.cu`` is held to on the card, against a float64
numpy evaluation from explicit powers z^(t0 + n); the wrapper's routing, its
run length, and refine_lines' use of it.  No JAX."""
import numpy as np
import pytest
import torch

from llckbdm_tpu_torch.ops import _build, cuda_linalg
from llckbdm_tpu_torch.signals import LineList
from llckbdm_tpu_torch.solver import refine as refine_mod
from llckbdm_tpu_torch.solver.refine import RefineConfig, refine_lines
from llckbdm_tpu_torch.tools.normal_checks import (DWELL, normal_errors,
                                                  normal_inputs)


def _numpy_doz(z, d):
    """d conj(z) / |z|^2 in float32 numpy from z, d rounded to complex64,
    0 on a masked slot (z = 0)."""
    z32, d32 = z.astype(np.complex64), d.astype(np.complex64)
    zabs2 = z32.real * z32.real + z32.imag * z32.imag
    live = zabs2 > 0
    inv = np.divide(np.float32(1), zabs2, out=np.zeros_like(zabs2),
                    where=live)
    return np.where(live, d32 * z32.conj() * inv, np.complex64(0))


def _numpy_normal(c, z, d, t0):
    """P, r, G and the rhs in float64 from P[k, n] = z_k ** (t0 + n), with
    a float32 doz (as refine.py forms it) widened."""
    c, z, d = (x.numpy() for x in (c, z, d))
    w = (t0 + np.arange(c.shape[-1])).astype(np.float64)
    p = z[..., None] ** w.astype(np.int64)
    r = c - np.einsum("vk,vkn->vn", d, p)
    dj = _numpy_doz(z, d).astype(np.complex128)[..., None] * w * p
    jac = np.concatenate([p, dj], axis=-2)
    g = np.einsum("vkn,vln->vkl", jac.conj(), jac)
    rhs = np.einsum("vkn,vn->vk", jac.conj(), r)
    return p, r, g, rhs


@pytest.mark.parametrize("v, nc, n, t0", [
    (3, 4, 64, 0), (2, 16, 512, 0), (2, 6, 200, 37), (1, 5, 300, 1000),
    (2, 32, 256, 0), (3, 9, 97, 5)])
def test_plain_matches_float64_numpy(v, nc, n, t0):
    c, z, d, mask = normal_inputs(v, nc, n, t0, seed=v * nc + t0)
    p_np, r_np, g_np, rhs_np = _numpy_normal(c, z, d, t0)
    p, r = cuda_linalg._powers_residual(c, z, d, t0)
    scale = np.abs(c.numpy()).max()
    assert np.abs(r.numpy() - r_np).max() <= 1e-12 * scale
    assert np.abs(p.numpy() - p_np).max() <= 1e-12
    g, rhs = cuda_linalg.gn_normal_plain(c, z, d, t0)
    assert g.dtype == torch.complex64 and rhs.dtype == torch.complex128
    assert g.shape == (v, 2 * nc, 2 * nc) and rhs.shape == (v, 2 * nc)
    eg, er = normal_errors(g, rhs, g_np, rhs_np, mask)
    assert eg <= 1e-5 and er <= 1e-6, (eg, er)


def test_masked_slots_have_the_powers_cpowers_gives():
    """A masked slot (z = d = 0) has P[k, 0] = 1 and 0 after it at t0 = 0,
    and 0 everywhere at t0 > 0, and doz 0; it adds nothing to the
    residual."""
    c, z, d, mask = normal_inputs(2, 5, 40, seed=3)
    for t0 in (0, 7):
        p, r = cuda_linalg._powers_residual(c, z, d, t0)
        dead = p.numpy()[~mask]
        want = np.zeros_like(dead)
        if t0 == 0:
            want[:, 0] = 1
        np.testing.assert_array_equal(dead, want)
    assert not cuda_linalg.doz_of(z, d).numpy()[~mask].any()


def test_doz_is_refines_float32_scale():
    """doz_of is d / z in float32 as the refinement formed it: d32 conj(z32)
    times the reciprocal of max(|z32|^2, 1e-20), 0 where a slot is masked."""
    _, z, d, mask = normal_inputs(3, 6, 8, seed=9)
    z32, d32 = z.to(torch.complex64), d.to(torch.complex64)
    zabs2 = z32.real * z32.real + z32.imag * z32.imag
    m = torch.as_tensor(mask)
    want = d32 * z32.conj() * torch.where(
        m, 1.0 / torch.clamp(zabs2, min=1e-20), 0.0)
    assert torch.equal(cuda_linalg.doz_of(z, d), want)
    np.testing.assert_allclose(cuda_linalg.doz_of(z, d).numpy()[mask],
                               (d / z).numpy()[mask], rtol=1e-6)


def test_wrapper_on_the_cpu_is_the_plain_version():
    """A CPU tensor takes the PyTorch code: the plain version's bits, no
    launch and no count of a plain version on a card."""
    _build.reset_counts()
    c, z, d, _ = normal_inputs(2, 7, 90, t0=3, seed=11)
    g, rhs = cuda_linalg.gn_normal(c, z, d, 3)
    g_p, rhs_p = cuda_linalg.gn_normal_plain(c, z, d, 3)
    assert torch.equal(g, g_p) and torch.equal(rhs, rhs_p)
    assert not _build.LAUNCHES and not _build.PLAIN_ON_CUDA


def test_wrapper_refuses_more_slots_than_the_kernel_takes(monkeypatch):
    """Where it would launch (a CUDA tensor; here the launch branch is
    forced, and the check raises before the library is touched) the
    wrapper takes C <= 32, the refine's limit on the card (its chol_solve
    takes 2C <= 64), and names the field to lower; a CPU tensor runs the
    PyTorch code at any C (tests/test_torch_wide.py's 40 clusters)."""
    c, z, d, _ = normal_inputs(1, 33, 16)
    g, _ = cuda_linalg.gn_normal(c, z, d)
    assert g.shape == (1, 66, 66)
    monkeypatch.setattr(_build, "use_kernel", lambda name, x: True)
    with pytest.raises(ValueError, match=r"k <= 32.*refined clusters C"):
        cuda_linalg.gn_normal(c, z, d)


@pytest.mark.parametrize("bad", ["c64", "d64", "shape", "t0"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    c, z, d, _ = normal_inputs(1, 3, 16)
    t0 = 0
    if bad == "c64":
        c = c.to(torch.complex64)
    elif bad == "d64":
        d = d.to(torch.complex64)
    elif bad == "shape":
        z = z[..., :2]
    else:
        t0 = -1
    with pytest.raises((TypeError, ValueError)):
        cuda_linalg.gn_normal(c, z, d, t0)


@pytest.mark.parametrize("nc, n, want", [
    (32, 2048, 64),     # the brain cell
    (16, 512, 32),      # five-peak: 16 sample groups, runs of 32
    (24, 2048, 64),
    (4, 64, 8),
    (24, 256, 32),
    (32, 8, 8)])
def test_plan_at_the_main_shapes(nc, n, want):
    assert cuda_linalg.gn_normal_run(nc, n) == want


@pytest.mark.parametrize("nc", [16, 32])
def test_plan_covers_every_run_once(nc):
    """Runs are 8..64 samples in steps of 8, and as long as they can be
    while every sample group of a block (16 at nc <= 16, else 8) has one."""
    groups = 16 if nc <= 16 else 8
    for n in (1, 8, 63, 64, 65, 512, 2048, 4097):
        run = cuda_linalg.gn_normal_run(nc, n)
        assert 8 <= run <= 64 and run % 8 == 0
        assert run == 8 or -(-n // run) >= groups
        assert run == 64 or -(-n // (2 * run)) < groups


def test_refine_builds_each_exact_step_through_gn_normal(monkeypatch):
    """refine_lines asks gn_normal for the normal equations once per exact
    iteration and never for a float32 warm-start one."""
    calls = []
    real = cuda_linalg.gn_normal

    def spy(*args, **kw):
        calls.append(args[-1])
        return real(*args, **kw)

    monkeypatch.setattr(refine_mod.cuda_linalg, "gn_normal", spy)
    c, z, d, mask = normal_inputs(2, 4, 128, seed=5)
    dt = float(np.float32(DWELL))
    zz = z.to(torch.complex64)
    lines = LineList(
        amplitude=d.abs().to(torch.float32),
        t2=torch.where(torch.as_tensor(mask),
                       -dt / torch.log(zz.abs().clamp(min=1e-30)), 1.0),
        frequency=(torch.angle(zz) / (2 * np.pi * dt)).to(torch.float32),
        phase=torch.angle(d).to(torch.float32),
        mask=torch.as_tensor(mask, dtype=torch.float32))
    refine_lines(c, lines, DWELL, RefineConfig(iters=3, f32_iters=2))
    assert calls == [0, 0, 0]
    calls.clear()
    refine_lines(c, lines, DWELL, RefineConfig(iters=0, f32_iters=2))
    assert calls == []
    calls.clear()
    refine_lines(c[..., 64:], lines, DWELL, RefineConfig(iters=2),
                 t_offset=64)
    assert calls == [64, 64]
