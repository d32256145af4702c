"""Training augmentation on the device (``crnn_ocr_tpu/ops/augment.py``).

After preprocessing, over the whole (B, H, W) f32 batch: brightness and
contrast jitter, Gaussian noise, and a small random affine warp (shear,
rotation, translation) through the STN's sampler
(``ops.grid_sample.grid_sample_affine``), so on a CUDA tensor the warp is
K11. The augmented image takes no gradient, so K12 never runs here.

The draws are apart from the math: ``augment_draws`` makes them on a
generator's device, ``augment_with_draws`` applies them, and
``augment_batch`` composes the two. ``jax.random``'s bits cannot be made
in PyTorch, so the port's stream is its own: batch ``index`` of a run
draws from a generator seeded with ``augment_seed_for(augment_seed,
index)``, a stream that depends on (seed, index) alone, as JAX's
``fold_in(key(augment_seed), index)`` does, so a resumed run draws what a
straight run draws. A CUDA generator and a CPU generator draw different
numbers for one seed: compare devices on given draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from crnn_ocr_torch.ops.grid_sample import grid_sample_affine
from crnn_ocr_torch.parallel.mesh import is_dp

# hashed into the augmentation's seed beside (seed, index), so that with
# augment_seed == seed and index == step its generator is not seeded as
# that step's dropout generator (train/step.py::step_seed hashes (seed,
# step)) and the noise does not repeat the dropout masks' draws
_STREAM_TAG = 1


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    brightness: float = 0.1  # +- additive, in normalized units
    contrast: float = 0.1  # +- multiplicative
    noise_std: float = 0.03
    shear: float = 0.08  # horizontal shear extent (normalized)
    rotate: float = 0.02  # radians
    translate: float = 0.02  # fraction of extent
    enabled: bool = True


def augment_seed_for(augment_seed: int, index: int) -> int:
    """The seed of batch ``index``'s augmentation generator in a run
    seeded ``augment_seed``: numpy's ``SeedSequence`` hash of
    ``(augment_seed, index, 1)``."""
    return int(np.random.SeedSequence(
        [augment_seed, index, _STREAM_TAG]).generate_state(1, np.uint64)[0])


def augment_generator(device, augment_seed: int, index: int
                      ) -> torch.Generator:
    """A generator on ``device`` seeded for batch ``index`` (no host sync:
    seeding sets the generator's state on the host)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(augment_seed_for(augment_seed, index))
    return gen


def _uniform(shape, lo: float, hi: float, gen) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (hi - lo) + lo


def augment_draws(B: int, H: int, W: int, generator: torch.Generator,
                  cfg: AugmentConfig = AugmentConfig()
                  ) -> Dict[str, torch.Tensor]:
    """One batch's random draws, f32 on the generator's device, made in
    this order: ``brightness`` (B, 1, 1) uniform in +-cfg.brightness;
    ``contrast`` (B, 1, 1), the factor 1 + uniform in +-cfg.contrast;
    ``noise`` (B, H, W), cfg.noise_std times a standard normal; ``shear``
    (B,) uniform in +-cfg.shear; ``rotation`` (B,) in radians, uniform in
    +-cfg.rotate; ``translation`` (B, 2) uniform in +-cfg.translate."""
    g = generator
    out = {"brightness": _uniform((B, 1, 1), -cfg.brightness,
                                  cfg.brightness, g)}
    out["contrast"] = 1.0 + _uniform((B, 1, 1), -cfg.contrast, cfg.contrast,
                                     g)
    out["noise"] = cfg.noise_std * torch.randn((B, H, W), generator=g,
                                               device=g.device)
    out["shear"] = _uniform((B,), -cfg.shear, cfg.shear, g)
    out["rotation"] = _uniform((B,), -cfg.rotate, cfg.rotate, g)
    out["translation"] = _uniform((B, 2), -cfg.translate, cfg.translate, g)
    return out


def augment_with_draws(x: torch.Tensor, draws: Dict[str, torch.Tensor]
                       ) -> torch.Tensor:
    """x (B, H, W) f32 preprocessed frames -> augmented frames, in JAX's
    order: ``x * contrast + brightness``, plus the noise, then the warp by
    theta ``[cos r, sh - sin r, tx, sin r, cos r, ty]``.

    ``cos`` and ``sin`` are taken in f64 and rounded once, which gives
    XLA's f32 bits for all but a few in 10^4 angles (torch's f32 ``cos``
    is an ulp off for 4 % of them): an ulp of theta moves a sample by up
    to ~1e-5 px."""
    x = x * draws["contrast"] + draws["brightness"]
    x = x + draws["noise"]
    r, sh, t = draws["rotation"], draws["shear"], draws["translation"]
    f64 = torch.float64
    cos, sin = torch.cos(r.to(f64)).float(), torch.sin(r.to(f64)).float()
    theta = torch.stack([cos, sh - sin, t[:, 0], sin, cos, t[:, 1]], dim=1)
    return grid_sample_affine(x[..., None], theta)[..., 0]


def augment_batch(x: torch.Tensor, generator: Optional[torch.Generator],
                  cfg: AugmentConfig = AugmentConfig(),
                  mesh=None) -> torch.Tensor:
    """``augment_with_draws`` of draws from ``generator`` (on x's
    device); ``cfg.enabled=False`` returns x. On a process ``mesh`` (a
    ``parallel.mesh.Mesh``; x the rank's rows) the global batch's draws are
    made and the rank's rows kept, so each row draws what it draws on one
    device."""
    if not cfg.enabled:
        return x
    B, H, W = x.shape
    if not is_dp(mesh):
        return augment_with_draws(x, augment_draws(B, H, W, generator, cfg))
    rows = mesh.rows(B * mesh.world)
    draws = augment_draws(B * mesh.world, H, W, generator, cfg)
    return augment_with_draws(x, {k: v[rows] for k, v in draws.items()})
