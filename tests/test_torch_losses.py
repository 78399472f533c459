"""The port's losses (ops/ssim.py, train/losses.py) against the JAX
package's, values and gradients, on seeded numpy images."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.ops import ssim as jssim
from opengaussian_tpu.train import losses as jlosses
from opengaussian_tpu_torch.ops import ssim as tssim
from opengaussian_tpu_torch.train import losses as tlosses

torch.set_num_threads(1)


def images(h=37, w=53, c=3, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, c)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_band_matrix_is_the_jax_one():
    for n in (5, 11, 48, 97):
        np.testing.assert_array_equal(tssim._band_matrix(n), jssim._band_matrix(n))


@pytest.mark.parametrize("shape", [(48, 64, 3), (37, 53, 6)])
def test_ssim_value_and_grad_match_jax(shape):
    a, b = images(*shape)
    want_v, want_g = jax.value_and_grad(jssim.ssim)(jnp.asarray(a), jnp.asarray(b))
    x = torch.tensor(a, requires_grad=True)
    v = tssim.ssim(x, torch.tensor(b))
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(want_v), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=1e-8, rtol=1e-4)


@pytest.mark.parametrize("lam", [0.0, 0.2])
def test_rgb_loss_value_and_grad_match_jax(lam):
    a, b = images(seed=3)
    want_v, want_g = jax.value_and_grad(jlosses.rgb_loss)(jnp.asarray(a), jnp.asarray(b), lam)
    x = torch.tensor(a, requires_grad=True)
    v = tlosses.rgb_loss(x, torch.tensor(b), lam)
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(want_v), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=1e-8, rtol=1e-4)


def test_masked_l1_l2_and_psnr_match_jax():
    a, b = images(seed=4)
    mask = (np.random.default_rng(5).uniform(size=a.shape[:2] + (1,)) > 0.5).astype(np.float32)
    ta, tb, tm = map(torch.tensor, (a, b, mask))
    ja, jb, jm = map(jnp.asarray, (a, b, mask))
    for name in ("l1_loss", "l2_loss"):
        for args_t, args_j in (((ta, tb), (ja, jb)), ((ta, tb, tm), (ja, jb, jm)),
                               ((ta, tb, tm, 0.5), (ja, jb, jm, 0.5))):
            np.testing.assert_allclose(float(getattr(tlosses, name)(*args_t)),
                                       float(getattr(jlosses, name)(*args_j)), rtol=1e-5)
    np.testing.assert_allclose(float(tlosses.psnr(ta, tb)), float(jlosses.psnr(ja, jb)),
                               rtol=1e-5)
    assert float(tlosses.psnr(ta, ta)) == pytest.approx(120.0)
