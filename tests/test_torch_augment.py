"""Port parity: the training augmentation and the pipeline's
``normalize``/``augment`` options (``crnn_ocr_torch/ops/augment.py``,
``data/pipeline.py``) against ``crnn_ocr_tpu``'s.

``jax.random``'s bits cannot be made in PyTorch, so the test rebuilds the
draws of JAX's ``augment_batch`` with ``jax.random`` itself (the same key,
split and call order as ``crnn_ocr_tpu/ops/augment.py:45-60``) and hands
them to the port's ``augment_with_draws``. Its output is held to JAX's at
1e-5 (the tolerance ``tests/test_torch_grid_sample.py`` holds the sampler
to at equal coordinates) plus one ulp of a sample's pixel position times
the frame's steepest step between neighbouring pixels: XLA fuses the
grid's affine into the position (with FMAs) inside ``augment_batch``, and
an f32 position near x = 150 has an ulp of 1.5e-5 px. JAX's own two
samplers (banded and gather) differ by 8.9e-6 on the smooth frames below.
The port's own draws are held to their ranges and to their stream's
contract: one (seed, index) gives one output. The preprocessed frames
without augmentation: atol 1e-4, as ``tests/test_torch_preprocess.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.data import pipeline as tpipe
from crnn_ocr_torch.ops import augment as taug
from crnn_ocr_torch.train.step import step_seed
from crnn_ocr_tpu.data import pipeline as jpipe
from crnn_ocr_tpu.data.synthetic import SyntheticConfig as JSynthCfg
from crnn_ocr_tpu.data.synthetic import SyntheticTextlines as JSynth
from crnn_ocr_tpu.ops import augment as jaug


def _jax_draws(key, B, H, W, cfg=jaug.AugmentConfig()):
    """The draws JAX's ``augment_batch(x, key, cfg)`` makes, in the port's
    names."""
    k_b, k_c, k_n, k_sh, k_r, k_t = jax.random.split(key, 6)
    u = jax.random.uniform
    draws = {
        "brightness": u(k_b, (B, 1, 1), minval=-cfg.brightness,
                        maxval=cfg.brightness),
        "contrast": 1.0 + u(k_c, (B, 1, 1), minval=-cfg.contrast,
                            maxval=cfg.contrast),
        "noise": cfg.noise_std * jax.random.normal(k_n, (B, H, W)),
        "shear": u(k_sh, (B,), minval=-cfg.shear, maxval=cfg.shear),
        "rotation": u(k_r, (B,), minval=-cfg.rotate, maxval=cfg.rotate),
        "translation": u(k_t, (B, 2), minval=-cfg.translate,
                         maxval=cfg.translate),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def _frames(seed, B=6, H=32, W=96):
    """Smooth random frames: each row a scaled random walk."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W)).astype(np.float32)
    return (np.cumsum(x, axis=2) / np.sqrt(W) + x * 0.1).astype(np.float32)


def _text_frames(B=6, bucket=128):
    """Preprocessed synthetic text lines: sharp edges."""
    b = _host(1, B, bucket)[0]
    return np.asarray(jpipe.produce_batch(dict(b))["x"])


def _tolerance(x, draws):
    """1e-5 plus one ulp of the largest pixel position times the steepest
    step between neighbouring pixels of the frame the warp reads."""
    pre = (x * draws["contrast"].numpy() + draws["brightness"].numpy()
           + draws["noise"].numpy())
    step = max(np.abs(np.diff(pre, axis=1)).max(),
               np.abs(np.diff(pre, axis=2)).max())
    ulp = np.spacing(np.float32(max(x.shape[1:]) - 1))
    return 1e-5 + float(ulp * step)


@pytest.mark.parametrize("case", ["smooth-96", "smooth-256", "smooth-24",
                                  "text-128", "text-256"])
def test_augment_with_jax_draws_matches_jax(case):
    seed = {"smooth-96": 0, "smooth-256": 1, "smooth-24": 2, "text-128": 3,
            "text-256": 4}[case]
    kind, w = case.split("-")
    x = (_frames(seed, 6, 32 if w != "24" else 16, int(w)) if kind ==
         "smooth" else _text_frames(6, int(w)))
    key = jax.random.fold_in(jax.random.key(11), seed)
    draws = _jax_draws(key, *x.shape)
    want = np.asarray(jaug.augment_batch(jnp.asarray(x), key))
    got = taug.augment_with_draws(torch.from_numpy(x), draws)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_tolerance(x, draws))


def test_disabled_is_the_identity_and_the_stream_is_keyed_by_index():
    x = torch.from_numpy(_frames(3).astype(np.float32))
    off = taug.AugmentConfig(enabled=False)
    assert taug.augment_batch(x, None, off) is x
    a = taug.augment_batch(x, taug.augment_generator("cpu", 5, 7))
    b = taug.augment_batch(x, taug.augment_generator("cpu", 5, 7))
    c = taug.augment_batch(x, taug.augment_generator("cpu", 5, 8))
    d = taug.augment_batch(x, taug.augment_generator("cpu", 6, 7))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    assert not torch.equal(a, x)


def test_augmentation_stream_is_apart_from_the_dropout_stream():
    """With ``augment_seed == seed`` and ``index == step`` the two
    generators are seeded apart, so the noise does not repeat a dropout
    mask's draws."""
    for s, i in ((0, 0), (3, 17), (2 ** 31, 5)):
        assert taug.augment_seed_for(s, i) != step_seed(s, i)
        g = taug.augment_generator("cpu", s, i)
        h = torch.Generator().manual_seed(step_seed(s, i))
        assert not torch.equal(torch.rand(64, generator=g),
                               torch.rand(64, generator=h))


def test_draws_lie_in_their_ranges():
    cfg = taug.AugmentConfig()
    B, H, W = 512, 32, 64
    d = taug.augment_draws(B, H, W, taug.augment_generator("cpu", 1, 2), cfg)
    shapes = {"brightness": (B, 1, 1), "contrast": (B, 1, 1),
              "noise": (B, H, W), "shear": (B,), "rotation": (B,),
              "translation": (B, 2)}
    assert {k: tuple(v.shape) for k, v in d.items()} == shapes
    assert all(v.dtype == torch.float32 for v in d.values())
    for key, lo, hi in (("brightness", -cfg.brightness, cfg.brightness),
                        ("contrast", 1 - cfg.contrast, 1 + cfg.contrast),
                        ("shear", -cfg.shear, cfg.shear),
                        ("rotation", -cfg.rotate, cfg.rotate),
                        ("translation", -cfg.translate, cfg.translate)):
        v = d[key]
        assert lo <= float(v.min()) and float(v.max()) <= hi, key
        # spread over the range, not stuck at a point
        assert float(v.max() - v.min()) > 0.9 * (hi - lo), key
    n = d["noise"]
    se = cfg.noise_std / np.sqrt(n.numel())
    assert abs(float(n.mean())) < 4 * se
    assert abs(float(n.std()) - cfg.noise_std) < 0.01 * cfg.noise_std


def _host(n=3, B=8, bucket=128):
    synth = JSynth(JSynthCfg(alphabet="0123456789", min_len=2, max_len=6))
    return list(jpipe.synthetic_batches(batch_size=B, bucket=bucket, seed=4,
                                        steps=n, synth=synth))


@pytest.mark.parametrize("normalize", [False, True])
def test_produce_batch_matches_jax_without_augmentation(normalize):
    b = _host(1)[0]
    want = jpipe.produce_batch(dict(b), normalize=normalize)
    got = tpipe.produce_batch(dict(b), "cpu", TorchConfig(),
                              normalize=normalize)
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["input_length"].numpy(),
                                  np.asarray(want["input_length"]))
    if not normalize:  # /255 only: the frames' grey levels
        assert 0.0 <= float(got["x"].min()) and float(got["x"].max()) <= 1.0


def test_device_batches_augment_offset_is_the_streams_tail():
    host = _host(4)
    cfg = TorchConfig()
    kw = dict(prefetch=0, augment=True, augment_seed=9)
    full = [b["x"] for b in tpipe.device_batches(iter(host), "cpu", cfg,
                                                 **kw)]
    tail = [b["x"] for b in tpipe.device_batches(iter(host[2:]), "cpu", cfg,
                                                 augment_offset=2, **kw)]
    assert len(tail) == 2
    for a, b in zip(full[2:], tail):
        assert torch.equal(a, b)
    # each batch takes its own index's draws, as produce_batch(index=n)
    one = tpipe.produce_batch(dict(host[3]), "cpu", cfg, augment=True,
                              augment_seed=9, index=3)
    assert torch.equal(one["x"], full[3])
    plain = next(tpipe.device_batches(iter(host), "cpu", cfg, prefetch=0))
    assert not torch.equal(plain["x"], full[0])
