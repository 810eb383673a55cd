"""The port's tiny sampler under each guidance option against the JAX
sampler (the harness of ``tests/test_torch_sampler_options.py``: fp32 on
the CPU, JAX's noise injected, the video held to 1e-3 absolute).

- DDIM at ``eta = 1``: the variance term with JAX's per-step draws injected
  through ``step_noise``;
- no CFG (``guidance_scale = 1``): batch B throughout, the context the cond
  rows alone. The JAX ``_sample_jit`` always doubles the context, and its
  denoise scan then fails on a carry of 2B rows, so the JAX side runs its
  encode, ``prepare_latents``, ``denoise`` and decode with the cond rows, as
  the reference pipeline encodes without CFG;
- ``share_cfg_prefix=False``: the latents duplicated before the UNet; it
  must also agree with the shared-prefix request, which is exact math;
- ``video_scale = 1.5``: the 3-term guidance with the per-frame pass (frames
  folded into the batch, F = 1, no fps conditioning, the context tiled
  ``[uncond; cond; …][:B·F]``).
"""

import numpy as np

from tests.test_torch_pipeline import EXACT
from tests.test_torch_sampler_options import ATOL, sample_both


def test_ddim_eta_matches_jax():
    got, want = sample_both(dict(EXACT, eta=1.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_no_cfg_matches_jax():
    got, want = sample_both(dict(EXACT, guidance_scale=1.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_unshared_cfg_prefix_matches_jax():
    got, want = sample_both(dict(EXACT, share_cfg_prefix=False))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    shared, _ = sample_both(EXACT, jax_side=False)
    np.testing.assert_allclose(got, shared, rtol=0, atol=ATOL)


def test_video_scale_matches_jax():
    got, want = sample_both(dict(EXACT, video_scale=1.5))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
