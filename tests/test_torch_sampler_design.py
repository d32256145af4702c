"""The cluster design of K12, the sampler's backward (``csrc/grid_sample.cu::
sample_bwd_cluster``), checked on the CPU where it is plain Python or plain
arithmetic.

* ``grid_sample.plan``: a cluster of at most 8 CTAs; every instance's
  shared memory within the H100's 232,448 bytes a CTA; the grid a multiple
  of the cluster; the CTAs' pixel slices cover H * W exactly once (also at
  H = 1 and H * W below the cluster) and their sample spans cover N
  exactly once; the gate admits every shape the JAX package's
  ``sampler_supported`` admits and raises past its own limit.
* A numpy model of the kernel: each CTA's samples as its threads take
  them from its ring of x, y and g (chunks of 1024 samples, 2 a thread:
  sample k of thread t in chunk c is k * 512 + (t + 32 (k + 2 c)) mod
  512); in a warp with a lane clamped at a border, the left-column terms
  of each run of neighbouring lanes on one pixel summed into the run's
  last lane; each corner term added to the CTA's own tile of the image,
  then each pixel slice summed over the cluster's tiles in rank order, or,
  past a CTA's tile, routed to the CTA that owns its pixel; each slice
  written to ``d_img`` once. It equals ``sample_pix_bwd_plain`` (``dx``,
  ``dy`` bit for bit, ``d_img`` to 1e-5 + 1e-5 * |plain|, the card's
  tolerances) on the card tests' shapes and one past the first design's
  58,112-pixel limit. An off-by-one at a slice's, a span's or a chunk's
  edge shows here.
* On the CPU the wrapper takes its plain version and counts no launch.
"""

import collections

import numpy as np
import pytest
import torch

from crnn_ocr_torch.kernels import grid_sample as gs
from crnn_ocr_tpu.kernels.grid_sample import sampler_supported

def _slices(p, HW):
    """Each CTA's [lo, lo + count) of d_img, as the kernel writes them."""
    return [(r * p.slice, max(min(p.slice, HW - r * p.slice), 0))
            for r in range(p.cluster)]


@pytest.mark.parametrize("design", sorted(gs.DESIGNS))
def test_plan_covers_every_pixel_and_sample_once(design):
    shapes = [(128, 32, 256, 8192), (3, 16, 24, 384), (2, 5, 7, 1000),
              (1, 1, 1, 3), (2, 1, 7, 7), (2, 1, 3, 5), (4, 9, 13, 117)]
    for B, H, W, N in shapes:
        for itemsize in (2, 4):
            for cluster in ((1,) if design == "image"
                            else range(1, gs.MAX_CLUSTER + 1)):
                p = gs.plan(B, H, W, N, itemsize, design, cluster)
                HW = H * W
                assert p.design == design
                assert 1 <= p.cluster <= gs.MAX_CLUSTER
                assert p.ctas == B * p.cluster and p.ctas % p.cluster == 0
                assert p.smem_bytes <= gs.SMEM_MAX
                held = collections.Counter()
                for lo, count in _slices(p, HW):
                    held.update(range(lo, lo + count))
                assert held == collections.Counter(range(HW)), (H, W, p)
                spans = collections.Counter()
                for r in range(p.cluster):
                    spans.update(range(r * p.span,
                                       min(r * p.span + p.span, N)))
                assert spans == collections.Counter(range(N)), (N, p)
                if design != "image":
                    # 16-byte stores of each slice, float4 zero fill
                    assert p.slice % 4 == 0 and p.span % 4 == 0
                    assert p.tile  # every one of these shapes fits one
                    acc = -(-HW // 4) * 4 if p.tile else p.slice
                    image = -(-HW * itemsize // 16) * 16
                    assert p.smem_bytes == (acc * 4 + gs.RING_BYTES
                                            + image * p.staged)


def test_plan_at_the_path_shapes():
    # training (B 128): a cluster of 2 a frame, 256 CTAs, one wave
    p = gs.plan(128, 32, 256, 8192, 2)
    assert p == gs.Plan("cluster", 2, True, 4096, 4096, True,
                        8192 * 4 + gs.RING_BYTES + 8192 * 2, 256)
    assert p.ctas <= gs.WAVE_CTAS
    # serving (B 256): a CTA a frame already fills the card
    assert gs.plan(256, 32, 256, 8192, 2).cluster == 1
    assert gs.plan(3, 32, 256, 8192, 4).cluster == 2
    # the largest image JAX admits, at a batch past one wave: slices of
    # 2 CTAs
    assert gs.plan(256, 128, 512, 65536, 4).cluster == 2


def test_gate_admits_every_shape_jax_admits():
    B = 2
    admitted = 0
    for W in (1, 7, 128, 256, 384, 500, 512):
        for H in sorted({1, 2, 32, 64, 128, 256, 512, 65536 // W,
                         65536 // W + 1}):
            if not sampler_supported((B, H, W, 1), (B, H, W, 2)):
                continue
            admitted += 1
            for batch, itemsize in ((B, 2), (B, 4), (1000, 2), (1000, 4)):
                p = gs.plan(batch, H, W, H * W, itemsize)
                assert p.smem_bytes <= gs.SMEM_MAX
                assert p.slice * 4 <= gs.SMEM_MAX
    assert admitted >= 10
    # the largest image JAX admits: past a CTA's tile (and the first
    # design's limit), so a slice a CTA, the image read through L1
    for itemsize in (2, 4):
        p = gs.plan(B, 128, 512, 65536, itemsize)
        assert not p.tile and not p.staged
    with pytest.raises(ValueError, match="58112"):
        gs.plan(B, 128, 512, 65536, 4, "image")


def test_plan_refuses_what_no_kernel_takes():
    limit = gs.MAX_CLUSTER * ((gs.SMEM_MAX - gs.RING_BYTES) // 4)
    assert gs.plan(1, 1, limit, 8, 4).cluster == gs.MAX_CLUSTER
    with pytest.raises(ValueError, match="shared memory"):
        gs.plan(1, 1, limit + 4, 8, 4)
    with pytest.raises(ValueError, match="CTAs a cluster"):
        gs.plan(1, 32, 256, 8192, 2, "cluster", gs.MAX_CLUSTER + 1)
    with pytest.raises(ValueError, match="no design"):
        gs.plan(1, 32, 256, 8192, 2, "thread")
    with pytest.raises(ValueError, match="empty"):
        gs.plan(1, 0, 256, 8192, 2)


# ---------------------------------------------------------------- the model

THREADS = gs.THREADS


def _sample_order(p, N, r):
    """CTA r's samples as its threads take them: (chunk c, sample k, thread
    t) -> sample index, and whether it is in the CTA's span."""
    n0, n1 = r * p.span, min(r * p.span + p.span, N)
    chunks = max(-(-(n1 - n0) // gs.CHUNK), 0)
    per = gs.CHUNK // THREADS
    c = np.arange(chunks)[:, None, None]
    k = np.arange(per)[None, :, None]
    t = np.arange(THREADS)[None, None, :]
    n = n0 + c * gs.CHUNK + k * THREADS + ((t + 32 * (k + per * c))
                                           & (THREADS - 1))
    return n.ravel(), (n < n1).ravel()


def _terms(img, x, y, g, H, W):
    """Per sample, in float32 with each operation rounded, as
    ``sample_backward``: dx, dy and the four corners' (pixel, term, live)."""
    f32 = np.float32

    def axis(v, n):
        f = np.floor(v)
        w1 = (v - f).astype(f32)
        w0 = (f32(1) - w1).astype(f32)
        i = np.clip(f, -2, n).astype(np.int64)
        i0, i1 = np.clip(i, 0, n - 1), np.clip(i + 1, 0, n - 1)
        same = i0 == i1
        return (i0, i1, np.where(same, (w0 + w1).astype(f32), w0),
                np.where(same, f32(0), w1), ~same)

    x0, x1, mx0, mx1, two_x = axis(x, W)
    y0, y1, my0, my1, two_y = axis(y, H)
    v = [img[yy * W + xx] for yy, xx in ((y0, x0), (y0, x1), (y1, x0),
                                         (y1, x1))]
    s0 = (v[0] * mx0 + v[1] * mx1).astype(f32)
    s1 = (v[2] * mx0 + v[3] * mx1).astype(f32)
    dx = g * ((my0 * (v[1] - v[0])) + (my1 * (v[3] - v[2])))
    dy = g * (s1 - s0)
    g0, g1 = g * my0, g * my1
    corners = [(y0 * W + x0, g0 * mx0, np.ones_like(two_x)),
               (y0 * W + x1, g0 * mx1, two_x),
               (y1 * W + x0, g1 * mx0, two_y),
               (y1 * W + x1, g1 * mx1, two_x & two_y)]
    return dx.astype(f32), dy.astype(f32), corners


def _reduce_clamped(corners):
    """``reduce_clamped`` on lanes of 32 (the last axis): in a warp with a
    lane clamped at a border (slot 0 live, slot 1 not), slots 0 and 2 are
    summed over each run of neighbouring live lanes on one pixel into the
    run's last lane, and dropped from the others."""
    rows = [[a.reshape(-1, 32).copy() for a in c] for c in corners]
    warp = ((rows[0][2] & ~rows[1][2]).any(axis=1))[:, None]
    lane = np.arange(32)[None, :]
    for k in (0, 2):
        p, v, live = rows[k]
        key = np.where(live, p, -1 - lane)
        starts = np.ones_like(live)
        starts[:, 1:] = key[:, 1:] != key[:, :-1]
        ends = np.ones_like(live)
        ends[:, :-1] = starts[:, 1:]
        run = np.cumsum(starts, axis=1)
        for w in np.flatnonzero(warp[:, 0]):
            for rid in np.unique(run[w][live[w]]):
                lanes = np.flatnonzero((run[w] == rid) & live[w])
                v[w, lanes[-1]] = np.float32(v[w, lanes].sum(dtype=np.float32))
        rows[k][2] = np.where(warp, live & ends, live)
        # no two neighbouring lanes of such a warp add to one pixel
        kept = rows[k][2] & warp
        same = (p[:, 1:] == p[:, :-1]) & kept[:, 1:] & kept[:, :-1]
        assert not same.any()
    return rows


def _model(img, x, y, g, design, cluster):
    """The kernel, image by image and CTA by CTA: (d_img, dx, dy, the
    share of corner terms a CTA sent to another CTA, the terms added a
    sample)."""
    B, H, W = img.shape
    N = x.shape[1]
    HW = H * W
    p = gs.plan(B, H, W, N, 2, design, cluster)
    dimg = np.full((B, HW), np.nan, np.float32)
    dx = np.full((B, N), np.nan, np.float32)
    dy = np.full((B, N), np.nan, np.float32)
    sent = total = 0
    for b in range(B):
        acc_len = -(-HW // 4) * 4 if p.tile else p.slice
        acc = np.zeros((p.cluster, acc_len), np.float32)
        seen = np.zeros(N, np.int64)
        for r in range(p.cluster):
            n, on = _sample_order(p, N, r)
            if not n.size:
                continue
            np.add.at(seen, n[on], 1)
            m = np.where(on, n, 0)
            ddx, ddy, corners = _terms(img[b].ravel(), np.where(on, x[b, m], 0),
                                       np.where(on, y[b, m], 0),
                                       np.where(on, g[b, m], 0), H, W)
            dx[b, n[on]], dy[b, n[on]] = ddx[on], ddy[on]
            corners = _reduce_clamped([(pix, term, live & on)
                                       for pix, term, live in corners])
            for pix, term, live in corners:
                pix, term = pix[live], term[live]
                total += pix.size
                if p.tile:
                    np.add.at(acc[r], pix, term)
                    continue
                owner = pix // p.slice
                assert (owner < p.cluster).all()
                sent += int((owner != r).sum())
                np.add.at(acc, (owner, pix - owner * p.slice), term)
        assert (seen == 1).all()
        for r, (lo, count) in enumerate(_slices(p, HW)):
            if p.tile:  # summed in rank order
                s = acc[0, lo:lo + count].copy()
                for o in range(1, p.cluster):
                    s = (s + acc[o, lo:lo + count]).astype(np.float32)
                dimg[b, lo:lo + count] = s
            else:
                assert np.isnan(dimg[b, lo:lo + count]).all()
                dimg[b, lo:lo + count] = acc[r, :count]
    return (dimg.reshape(B, H, W), dx, dy, sent / max(total, 1),
            total / (B * N))


def _case(seed, B, H, W, N, near_identity=False):
    """An image, coordinates (overshooting every border, or a near-identity
    warp of N = H * W samples) and an upstream gradient, as bf16 image."""
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.normal(size=(B, H, W)).astype(np.float32))
    if near_identity:  # an affine warp: scaled, sheared and shifted
        yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        a = rng.uniform(-0.05, 0.05, (2, B, 1))
        x = (xx.ravel()[None] * (1.03 + a[0]) + yy.ravel()[None] * 0.02
             - 3.3).astype(np.float32)
        y = (yy.ravel()[None] * (0.92 + a[1]) + xx.ravel()[None] * 0.004
             + 0.4).astype(np.float32)
    else:
        x = rng.uniform(-3, W + 2, (B, N)).astype(np.float32)
        y = rng.uniform(-3, H + 2, (B, N)).astype(np.float32)
    g = rng.normal(size=(B, N)).astype(np.float32)
    return (img.to(torch.bfloat16), torch.from_numpy(x), torch.from_numpy(y),
            torch.from_numpy(g))


# the card tests' shapes (tests/test_torch_cuda.py), N % 4 != 0, and one
# past the first design's 58,112 pixels (the largest JAX admits)
SHAPES = {"training shape": (8, 32, 256, 8192), "16x24": (3, 16, 24, 384),
          "5x7": (2, 5, 7, 1000), "1x1": (1, 1, 1, 3),
          "N % 4 == 3": (3, 16, 24, 383), "H 1": (2, 1, 9, 10),
          "past 58,112 pixels": (1, 128, 512, 65536)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_model_of_the_cluster_design_matches_plain(shape):
    B, H, W, N = SHAPES[shape]
    img, x, y, g = _case(3, B, H, W, N)
    want = [t.numpy() for t in gs.sample_pix_bwd_plain(img, x, y, g)]
    got = _model(img.float().numpy(), x.numpy(), y.numpy(),
                 g.numpy(), "cluster", None)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    err = np.abs(got[0] - want[0])
    assert (err <= 1e-5 + 1e-5 * np.abs(want[0])).all(), err.max()


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_affine_warp_clamped_at_its_border(cluster):
    """An affine warp near the identity (the STN's, N = H * W) that runs
    past the image's left border: the clamped lanes' terms are one per run
    (``_reduce_clamped`` checks it), and no term leaves its CTA."""
    img, x, y, g = _case(5, 2, 32, 256, 8192, near_identity=True)
    assert (x < 0).any()
    want = gs.sample_pix_bwd_plain(img, x, y, g)[0].numpy()
    got = _model(img.float().numpy(), x.numpy(), y.numpy(), g.numpy(),
                 "cluster", cluster)
    assert (np.abs(got[0] - want) <= 1e-5 + 1e-5 * np.abs(want)).all()
    assert got[3] == 0


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    img, x, y, g = _case(7, 2, 5, 7, 30)
    counts = (gs.bwd_launches, dict(gs.design_launches))
    want = gs.sample_pix_bwd_plain(img, x, y, g)
    for design in gs.DESIGNS:
        got = gs.sample_pix_bwd(img, x, y, g, design)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert (gs.bwd_launches, dict(gs.design_launches)) == counts
