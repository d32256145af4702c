"""Port parity: data parallelism (``crnn_ocr_torch/parallel/``, sync-BN in
``models/crnn.py`` and ``kernels/fused_stem_train.py``, the DP paths of
``train/``, ``data/device_cache.py`` and ``infer/predictor.py``) against
``crnn_ocr_tpu``'s on its 8-device CPU mesh (``tests/conftest.py``) and
against the port's own single-device runs.

At the small configuration of ``tests/test_parallel.py:22-43``; every run
starts from one initial state, the port's seeded init, carried into JAX's
trees by ``params_from_jax`` read backwards (``torch_dp_ranks.jax_tree``),
with
dropout 0 (JAX's and the port's dropout streams differ) unless it is
compared with the port alone. Tolerances, as ``tests/test_torch_train.py``
holds the port's train step to JAX's and ``tests/test_parallel.py`` holds
JAX's DP step to its single-device step: loss and grad_norm rtol 2e-5;
updated parameters and BatchNorm statistics rtol 2e-4 / atol 2e-5, except
that where a gradient element is at the f32 noise of its sum (at most
1e-5 of its tensor's largest) Adam turns that noise into a step of up to
the learning rate, so such elements (at most 0.1 % of a tensor) are held
to ``2 * lr`` a step. Padded rows with garbage labels change the step by
no more than JAX's own test allows (loss rtol 1e-6, parameters atol 1e-7).

The ranks are processes spawned by ``parallel.spawn_ranks`` (gloo over a
file store in ``tmp_path``, a timeout on every collective and on the
join); they run ``tests/torch_dp_ranks.py``, which imports no JAX, and
hand their results back through files. No process group is initialized in
the test process.
"""

import concurrent.futures
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.data import pipeline as tpipe
from crnn_ocr_torch.data.synthetic import SyntheticConfig as TSynthCfg
from crnn_ocr_torch.data.synthetic import SyntheticTextlines as TSynth
from crnn_ocr_torch.infer import Predictor as TPredictor
from crnn_ocr_torch.infer import predictor_from_cli
from crnn_ocr_torch.infer.weights import params_from_jax
from crnn_ocr_torch.models.crnn import BatchNorm
from crnn_ocr_torch.parallel import make_mesh, mesh as mesh_lib
from crnn_ocr_torch.train import state as tstate
from crnn_ocr_torch.train import step as tstep

import torch_dp_ranks

# The JAX package's modules are imported where they are used: a pytest-xdist
# worker that does not run this file then does not pay for them when it
# collects it.

LR = 1e-4
SMALL = dict(width=64, stem_filters=8, block_filters=(16, 16, 24, 24),
             time_dense_size=16, n_units=16, rnn_layers=1, dropout_rate=0.0)
SPAWN_TIMEOUT_S = 120.0


def _jax_state(cfg, sd: dict):
    """JAX's train state (Adam at ``LR``, as ``create_train_state`` makes
    it) holding ``sd``'s weights: no ``model.init`` to compile."""
    from crnn_ocr_tpu.models import CRNN as JCRNN
    from crnn_ocr_tpu.train.state import TrainState as JTrainState
    from crnn_ocr_tpu.train.state import make_optimizer

    params, stats = jax.tree_util.tree_map(jnp.asarray,
                                           torch_dp_ranks.jax_tree(sd))
    return JTrainState.create(apply_fn=JCRNN(cfg=cfg).apply, params=params,
                              tx=make_optimizer("adam", LR),
                              batch_stats=stats)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The models here are tiny: two intra-op threads do their work, and
    leave the machine's other cores to the spawned ranks and to JAX."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """JAX's small model and a batch of 16 synthetic lines, as
    ``tests/test_parallel.py:22-43``: the stream is byte for byte
    JAX's, and both packages' steps take the port's preprocessed frames
    (within 1e-4 of JAX's, ``tests/test_torch_preprocess.py``) and start
    from the port's seeded init (flax's initializer families), carried
    into JAX's state."""
    from crnn_ocr_tpu.models import ModelConfig

    synth = TSynth(TSynthCfg(alphabet="0123456789", min_len=2, max_len=5))
    cfg = ModelConfig(num_classes=synth.codec.num_classes, **SMALL)
    tcfg = TorchConfig(num_classes=synth.codec.num_classes, **SMALL)
    sd = tstate.create_train_state(tcfg, seed=0, device="cpu").model \
        .state_dict()
    state = _jax_state(cfg, sd)
    batch = _batches(tcfg, synth, 0, 1)[0]
    return cfg, state, batch, tcfg, sd, synth


def _batches(tcfg, synth, seed: int, n: int) -> list:
    """``n`` batches of 16 lines of the synthetic stream ``seed``, as the
    port's ``device_batches`` makes them, in numpy."""
    return [{k: b[k].numpy() for k in ("x", "input_length", "the_labels",
                                       "label_length")}
            for b in tpipe.device_batches(tpipe.synthetic_batches(
                batch_size=16, bucket=64, seed=seed, steps=n, synth=synth),
                "cpu", tcfg, prefetch=0)]


def _jax_step(cfg, state, batch, mesh=None):
    """JAX's train step (on ``mesh``, sharded as ``tests/test_parallel.py``
    shards it): (metrics, the updated state as a port state dict)."""
    from crnn_ocr_tpu.parallel import replicate_state, shard_batch
    from crnn_ocr_tpu.train import make_train_step

    step = make_train_step(cfg, donate=False)
    if mesh is not None:
        state, batch = replicate_state(state, mesh), shard_batch(batch, mesh)
    else:
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
    new, m = step(state, batch, jax.random.key(11))
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, new.params),
                         jax.tree_util.tree_map(np.asarray, new.batch_stats))
    return {k: float(v) for k, v in m.items()}, sd


def _port_step(tcfg, sd, batch):
    """The port's single-device step (no mesh): (metrics, state dict,
    the step's clipped gradients)."""
    state = tstate.create_train_state(tcfg, sd, device="cpu",
                                      learning_rate=LR)
    m = tstep.make_train_step(tcfg)(state, {
        k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    grads = {n: p.grad.numpy().copy()
             for n, p in state.model.named_parameters()}
    return ({k: float(v) for k, v in m.items()},
            {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            grads)


def _model(snapshot):
    return {k[6:]: v for k, v in snapshot.items() if k.startswith("model/")}


def _assert_states_close(got, want, grads, steps=1):
    """``got`` and ``want``: state dicts after ``steps`` steps; ``grads``:
    the port's gradients of a step, whose near-zero elements Adam may move
    by up to the learning rate either way (the module docstring)."""
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g, w = got[name].float().numpy(), w.float().numpy()
        if name not in grads:  # BatchNorm running statistics
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5,
                                       err_msg=name)
            continue
        noise = np.abs(grads[name]) <= 1e-5 * np.abs(grads[name]).max()
        off = np.abs(g - w) > 2e-5 + 2e-4 * np.abs(w)
        assert not np.any(off & ~noise), (name, np.abs(g - w)[off].max())
        assert off.mean() <= 1e-3, name
        assert np.all(np.abs(g - w)[off] <= 2 * LR * steps), name


def _assert_metrics_close(got, want):
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=2e-5,
                                   err_msg=key)


# ---- pad_batch_to ----


def test_pad_batch_to_is_byte_equal_to_jax(setup):
    """The case of ``tests/test_parallel.py:97-108`` and a real batch (12
    of the 16 lines padded to 16): the same keys, dtypes and bytes."""
    from crnn_ocr_tpu.parallel import pad_batch_to as jpad_batch_to

    small = {"x": np.ones((5, 32, 64), np.float32),
             "input_length": np.full((5,), 10, np.int32),
             "the_labels": np.ones((5, 4), np.int32),
             "label_length": np.full((5,), 4, np.int32)}
    real = {k: v[:12] for k, v in setup[2].items()}
    for batch, size in ((small, 8), (real, 16)):
        got = mesh_lib.pad_batch_to(dict(batch), size)
        want = jpad_batch_to(dict(batch), size)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), k
    assert list(mesh_lib.pad_batch_to(small, 8)["valid_mask"]) == [1] * 5 + \
        [0] * 3


# ---- the padded step, in one process ----


@pytest.fixture(scope="module")
def padded_runs(spawned):
    return dict(spawned["padded"], jax_padded=spawned["jax_padded"].result())


def _padded_runs(setup):
    """The port's step on 12 lines, and on them padded to 16 (with garbage
    in the pad rows too)."""
    _, _, batch, tcfg, sd, _ = setup
    small = {k: v[:12] for k, v in batch.items()}
    padded = mesh_lib.pad_batch_to(dict(small), 16)
    garbage = {k: np.array(v) for k, v in padded.items()}
    garbage["the_labels"][12:] = 3
    garbage["label_length"][12:] = 4
    garbage["input_length"][12:] = 9
    return {"unpadded": _port_step(tcfg, sd, small),
            "padded": _port_step(tcfg, sd, padded),
            "garbage": _port_step(tcfg, sd, garbage)}


def _jax_padded_step(setup):
    """JAX's step on the 12 lines padded to 16, on its 8-device mesh."""
    from crnn_ocr_tpu.parallel import make_mesh as jmake_mesh
    from crnn_ocr_tpu.parallel import pad_batch_to as jpad_batch_to

    cfg, state, batch, _, _, _ = setup
    small = {k: v[:12] for k, v in batch.items()}
    return _jax_step(cfg, state, jpad_batch_to(small, 16), jmake_mesh(8))


def test_padded_step_matches_unpadded(padded_runs):
    """12 lines padded to 16 with a mask: the masked mean and the masked
    BatchNorm moments (the stem on its plain path) give the unpadded step,
    running statistics included."""
    um, usd, ug = padded_runs["unpadded"]
    pm, psd, _ = padded_runs["padded"]
    _assert_metrics_close(pm, um)
    _assert_states_close(psd, usd, ug)


def test_padded_step_ignores_garbage_in_pad_rows(padded_runs):
    pm, psd, _ = padded_runs["padded"]
    gm, gsd, _ = padded_runs["garbage"]
    np.testing.assert_allclose(gm["loss"], pm["loss"], rtol=1e-6)
    for k, v in psd.items():
        np.testing.assert_allclose(gsd[k].numpy(), v.numpy(), atol=1e-7,
                                   err_msg=k)


def test_padded_step_matches_jax_padded_step_on_its_mesh(padded_runs):
    pm, psd, pg = padded_runs["padded"]
    jm, jsd = padded_runs["jax_padded"]
    _assert_metrics_close(pm, jm)
    _assert_states_close(psd, jsd, pg)


@pytest.mark.parametrize("shape,dim", [((6, 4, 5, 3), -1), ((6, 7, 8), -1)],
                         ids=["nhwc", "btf"])
def test_masked_batchnorm_matches_flax(shape, dim):
    """The port's BatchNorm with a row mask against flax's ``nn.BatchNorm``
    with ``mask``: outputs and moved running statistics, rtol 1e-5 / atol
    1e-6 (f32 sums in another order)."""
    import flax.linen as fnn

    rng = np.random.default_rng(3)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32)
    C = shape[dim]
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(size=C).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-3)
    mask_b = mask.astype(bool).reshape((-1,) + (1,) * (len(shape) - 1))
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": np.zeros(C, np.float32),
                                 "var": np.ones(C, np.float32)}}
    want, upd = bn.apply(variables, x, mask=mask_b, mutable=["batch_stats"])
    port = BatchNorm(C, dim=dim).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
    got = port(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for t, k in ((port.running_mean, "mean"), (port.running_var, "var")):
        np.testing.assert_allclose(t.numpy(),
                                   np.asarray(upd["batch_stats"][k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# ---- two spawned ranks ----


def _spawn(worker, world, inputs, tmp):
    """Run ``worker`` on ``world`` gloo ranks; return their results."""
    path = os.path.join(tmp, "inputs.pt")
    torch.save(inputs, path)
    mesh_lib.spawn_ranks(worker, world,
                         args=(world, os.path.join(tmp, "store"), path, tmp),
                         timeout_s=SPAWN_TIMEOUT_S)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _stem_inputs():
    """``tests/test_parallel.py:408-458``'s shapes."""
    rng = np.random.default_rng(17)
    B, H, W, C = 4, 32, 48, 8
    return (rng.normal(size=(B, H, W, 1)).astype(np.float32),
            (rng.normal(size=(3, 3, 1, C)) * 0.3).astype(np.float32),
            rng.uniform(0.5, 1.5, C).astype(np.float32),
            (rng.normal(size=C) * 0.1).astype(np.float32))


def _jax_stem(img, conv_w, gamma, beta):
    """JAX's stem on one device, its XLA path (conv, batch-statistics
    BatchNorm, ReLU, max-pool, as ``crnn_ocr_tpu/models/crnn.py:337-340``
    computes it, f32 at HIGHEST precision): the loss, pooled, mean, var
    and the three gradients."""
    import flax.linen as fnn

    def loss(cw, g_, b_):
        z = jax.lax.conv_general_dilated(
            jnp.asarray(img), cw, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=jax.lax.Precision.HIGHEST)
        m = z.mean((0, 1, 2))
        v = (z * z).mean((0, 1, 2)) - m * m
        y = (z - m) * (jax.lax.rsqrt(v + 1e-3) * g_) + b_
        p = fnn.max_pool(jax.nn.relu(y), (2, 2), strides=(2, 2))
        return jnp.sum(jnp.sin(p * 1.3)), (p, m, v)

    (lv, (p, m, v)), g = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(conv_w), jnp.asarray(gamma), jnp.asarray(beta))
    return {"loss": float(lv), "pooled": np.asarray(p), "mean": np.asarray(m),
            "var": np.asarray(v), "d_w": np.asarray(g[0]),
            "d_gamma": np.asarray(g[1]), "d_beta": np.asarray(g[2])}


def _two_rank_inputs(setup, tmp):
    cfg, state, batch, tcfg, sd, synth = setup
    small = {k: v[:12] for k, v in batch.items()}
    drop_batches = _batches(tcfg, synth, 5, 2)
    fit_cfg = TorchConfig(num_classes=synth.codec.num_classes, width=64,
                          stem_filters=8, block_filters=(8, 8, 12, 12),
                          time_dense_size=8, n_units=8, rnn_layers=1,
                          dropout_rate=0.1)
    return {"cfg": tcfg, "sd": sd, "lr": LR, "batch": batch,
            "padded": mesh_lib.pad_batch_to(dict(small), 16),
            "drop_cfg": TorchConfig(**dict(tcfg.__dict__, dropout_rate=0.2)),
            "drop_batches": drop_batches, "stem": _stem_inputs(),
            "fit_cfg": fit_cfg, "work": tmp}


def _four_rank_inputs(tmp):
    """24 lines as PNGs, packed here (the ranks find the corpus packed)."""
    cv2 = pytest.importorskip("cv2")
    from crnn_ocr_torch.data.device_cache import DeviceResidentCorpus
    from crnn_ocr_torch.data.reader import Reader, ReaderConfig

    d = os.path.join(tmp, "data")
    os.makedirs(d)
    synth = TSynth(TSynthCfg(alphabet="0123456789", min_len=2, max_len=4))
    rng = np.random.default_rng(5)
    lines = []
    for i in range(24):
        images, texts = synth.sample_batch(1, rng)
        assert cv2.imwrite(os.path.join(d, f"img_{i}.png"), images[0])
        lines.append(f"img_{i}.png\t{texts[0]}")
    with open(os.path.join(d, "annotation.txt"), "w") as f:
        f.write("\n".join(lines))
    reader_kw = dict(val_fraction=0.0, max_label_len=8, pack_cache=True,
                     buckets=(64,), batch_size=8)
    DeviceResidentCorpus(Reader(ReaderConfig(path=d, **reader_kw)),
                         device="cpu")
    cfg = TorchConfig(num_classes=synth.codec.num_classes, width=64,
                      stem_filters=8, block_filters=(8, 8, 12, 12),
                      time_dense_size=8, n_units=8, rnn_layers=1,
                      dropout_rate=0.1)
    sd = tstate.create_train_state(cfg, seed=2, device="cpu").model \
        .state_dict()
    return {"cfg": cfg, "sd": sd, "lr": LR, "seed": 7, "path": d,
            "reader": reader_kw}


def _four_ranks(tmp: str):
    return _spawn(torch_dp_ranks.cached_worker, 4, _four_rank_inputs(tmp),
                  tmp)


@pytest.fixture(scope="module", autouse=True)
def four_spawned(tmp_path_factory):
    """The 4-rank spawn (``torch_dp_ranks.cached_worker``: no JAX input),
    started before anything else of the module; teardown waits for it."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(_four_ranks, str(tmp_path_factory.mktemp("dp4")))
    try:
        yield future
    finally:
        pool.shutdown(wait=True)


@pytest.fixture(scope="module", autouse=True)
def spawned(setup, tmp_path_factory):
    """The 2-rank spawn (``torch_dp_ranks.dp_worker``), started once JAX's
    initial state exists, and JAX's two steps on its 8-device mesh in
    threads of their own, while this thread computes the port's
    single-device steps and JAX's stem. Teardown waits for all."""
    from crnn_ocr_tpu.parallel import make_mesh as jmake_mesh

    cfg, state, batch, tcfg, sd, _ = setup
    tmp2 = str(tmp_path_factory.mktemp("dp2"))
    pool = concurrent.futures.ThreadPoolExecutor(3)
    out = {
        "two": pool.submit(_spawn, torch_dp_ranks.dp_worker, 2,
                           _two_rank_inputs(setup, tmp2), tmp2),
        "jax_dp": pool.submit(_jax_step, cfg, state, batch, jmake_mesh(8)),
        "jax_padded": pool.submit(_jax_padded_step, setup),
        "work": tmp2}
    try:
        out.update(single=_port_step(tcfg, sd, batch),
                   jax_stem=_jax_stem(*_stem_inputs()),
                   padded=_padded_runs(setup))
        yield out
    finally:
        pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def two_ranks(spawned):
    return dict({k: spawned[k] for k in ("single", "jax_stem", "work")},
                jax_dp=spawned["jax_dp"].result(),
                ranks=spawned["two"].result())


def test_dp_ranks_hold_one_state(two_ranks):
    """After each run every rank holds the same parameters, running
    statistics, optimizer slots and step, bit for bit."""
    r0, r1 = two_ranks["ranks"]
    for key in ("dp", "padded_dp", "dropout_dp"):
        for k, v in r0[key][1].items():
            assert torch.equal(v, r1[key][1][k]), (key, k)
        assert r0[key][0] == r1[key][0], key


def test_dp_step_matches_single_device_and_jax_dp(two_ranks):
    """The 16-line step on 2 ranks (8 rows each) against the port's
    single-device step and JAX's step on its 8-device mesh."""
    (dm,), dsd = two_ranks["ranks"][0]["dp"]
    sm, ssd, sg = two_ranks["single"]
    jm, jsd = two_ranks["jax_dp"]
    _assert_metrics_close(dm, sm)
    _assert_states_close(_model(dsd), ssd, sg)
    _assert_metrics_close(dm, jm)
    _assert_states_close(_model(dsd), jsd, sg)


def test_padded_dp_step_matches_padded_single(two_ranks, padded_runs):
    """12 lines padded to 16 on 2 ranks (rank 1 holds the 4 pad rows)
    against the port's padded single-device step and JAX's padded step."""
    (dm,), dsd = two_ranks["ranks"][0]["padded_dp"]
    pm, psd, pg = padded_runs["padded"]
    jm, jsd = padded_runs["jax_padded"]
    _assert_metrics_close(dm, pm)
    _assert_states_close(_model(dsd), psd, pg)
    _assert_metrics_close(dm, jm)
    _assert_states_close(_model(dsd), jsd, pg)


def test_dp_dropout_matches_single_device(two_ranks):
    """Dropout 0.2, two steps: each rank draws the global batch's masks and
    keeps its rows, so DP equals one device (at the DP tolerances)."""
    r0 = two_ranks["ranks"][0]
    sm, ssd = r0["dropout_single"]
    dm, dsd = r0["dropout_dp"]
    for g, w in zip(dm, sm):
        _assert_metrics_close(g, w)
    for k, v in ssd.items():
        if k.startswith("model/") and "running" in k:
            np.testing.assert_allclose(dsd[k].numpy(), v.numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=k)
        elif k.startswith("model/"):
            off = np.abs(dsd[k].numpy() - v.numpy()) > 2e-5 + 2e-4 * np.abs(
                v.numpy())
            assert off.mean() <= 1e-3, k
            assert np.all(np.abs(dsd[k].numpy() - v.numpy())[off]
                          <= 2 * LR * len(sm)), k


def test_fused_stem_sync_bn_matches_jax(two_ranks):
    """K8's and K9's reductions between the plain versions' launches, on 2
    ranks of 2 rows each at ``tests/test_parallel.py:408-458``'s shapes,
    against JAX's stem over the whole batch, at that test's tolerances
    (loss rtol 1e-5, mean and var rtol 1e-5 / atol 1e-6, pooled rtol 1e-5
    / atol 1e-5, gradients rtol 2e-3 / atol 1e-3), and against the port's
    single-device ``fused_stem_train`` on the whole batch. The JAX side is
    its XLA stem: its ``fused_stem_train_dispatch`` on a 2-device mesh, in
    interpret mode, takes 283 s to compile and run here (JAX's own test of
    it is marked slow), and ``tests/test_torch_stem_train.py`` holds the
    port's plain versions to JAX's fused train stem on one device."""
    got = two_ranks["ranks"][0]["stem"]
    want = two_ranks["jax_stem"]
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
    for k, rtol, atol in (("mean", 1e-5, 1e-6), ("var", 1e-5, 1e-6),
                          ("pooled", 1e-5, 1e-5), ("d_w", 2e-3, 1e-3),
                          ("d_gamma", 2e-3, 1e-3), ("d_beta", 2e-3, 1e-3)):
        np.testing.assert_allclose(got[k].detach().numpy(), want[k],
                                   rtol=rtol, atol=atol, err_msg=k)
    single = two_ranks["ranks"][0]["stem_single"]
    for k in ("mean", "var", "pooled", "d_w", "d_gamma", "d_beta"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   single[k].detach().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    r1 = two_ranks["ranks"][1]["stem"]
    for k in ("mean", "var", "d_w", "d_gamma", "d_beta", "pooled"):
        assert torch.equal(r1[k], got[k]), k


def test_fit_pads_ragged_batches_and_resumes_bitwise(two_ranks):
    """``fit`` on 2 ranks over batches of 11 lines (padded to 12), with an
    evaluation and a checkpoint every step written by rank 0 alone; a run
    restored at step 1 and fitted on to 2 equals the straight 2-step run
    bit for bit, parameters, statistics, optimizer slots and step."""
    r0, r1 = (r["fit"] for r in two_ranks["ranks"])
    assert r0["writes"] and not r1["writes"]
    assert r0["resumed_from"] == r1["resumed_from"] == 1
    for r in (r0, r1):
        assert int(r["straight"]["step"]) == 2
        assert sorted(r["resumed"]) == sorted(r["straight"])
        for k, v in r["straight"].items():
            assert torch.equal(r["resumed"][k], v), k
    for k, v in r0["straight"].items():
        assert torch.equal(r1["straight"][k], v), k
    # one writer: 2 train records and 2 evaluations, once
    with open(os.path.join(two_ranks["work"], "straight", "m.jsonl")) as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds.count("train") == 2 and kinds.count("eval") == 2


# ---- four spawned ranks: the K-step calls ----


@pytest.fixture(scope="module")
def four_ranks(four_spawned):
    return four_spawned.result()


def test_cached_k_steps_on_four_ranks_match_single_device(four_ranks):
    """Each rank gathers its own 2 rows of every 8-row batch from the full
    tables, draws the global augmentation and dropout and keeps its rows:
    the losses equal one device's at rtol 2e-5, the states at the DP
    tolerances (five Adam steps: an element off by the noise rule moves by
    at most 2 * lr a step), and every rank holds the same state."""
    r0 = four_ranks[0]
    single, dp = r0["single"], r0["dp"]
    assert dp["losses"].shape == single["losses"].shape == (5,)
    np.testing.assert_allclose(dp["losses"].numpy(),
                               single["losses"].numpy(), rtol=2e-5)
    for k, v in single["state"].items():
        g, w = dp["state"][k].float().numpy(), v.float().numpy()
        if "running" in k or k == "step" or k.startswith("opt/"):
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5,
                                       err_msg=k)
            continue
        off = np.abs(g - w) > 2e-5 + 2e-4 * np.abs(w)
        assert off.mean() <= 1e-3, k
        assert np.all(np.abs(g - w)[off] <= 2 * LR * 5), k
    for r in four_ranks[1:]:
        for k, v in dp["state"].items():
            assert torch.equal(r["dp"]["state"][k], v), (r["rank"], k)


# ---- the local mesh ----


def test_mesh_predictor_matches_single_device(setup):
    """``Predictor(mesh=make_mesh(devices=["cpu"] * 8))`` on 11 lines (11 %
    8 != 0: blank rows pad the batch before the canvas is packed) against
    the single-device predictor, as ``tests/test_parallel.py:487-517``:
    labels equal, probabilities rtol 1e-5 / atol 1e-6, texts equal."""
    _, _, _, tcfg, sd, synth = setup
    images, _ = synth.sample_batch(11, np.random.default_rng(23))
    single = TPredictor(tcfg, sd, synth.codec, buckets=(64,), device="cpu")
    dp = TPredictor(tcfg, sd, synth.codec, buckets=(64,),
                    mesh=make_mesh(devices=["cpu"] * 8))
    assert dp.mesh.size == 8 and len(dp.replicas) == 1
    p1, l1 = single.predict_probs(list(images))
    p2, l2 = dp.predict_probs(list(images))
    assert p2.shape == p1.shape
    np.testing.assert_array_equal(l1.numpy(), l2.numpy())
    np.testing.assert_allclose(p1.numpy(), p2.numpy(), rtol=1e-5, atol=1e-6)
    assert single.predict_text(list(images)) == dp.predict_text(list(images))


def test_predictor_from_cli_mesh():
    """``n_devices`` builds a local mesh: on CUDA over the cards, raising
    JAX's message where there are too few; on the CPU as shards of the one
    CPU."""
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match=(
                "requested a 2-device mesh but only "
                f"{torch.cuda.device_count()} devices are available")):
            predictor_from_cli(None, "fonts-small", n_devices=2)
    pred = predictor_from_cli(None, "fonts-small", n_devices=2, device="cpu")
    assert pred.mesh.size == 2 and pred.device.type == "cpu"
