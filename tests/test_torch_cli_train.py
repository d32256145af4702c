"""Port parity: the training CLI (``crnn_ocr_torch/cli/train.py``) against
``crnn_ocr_tpu/cli/train.py``, its data-parallel ranks, and the builders'
cross-process lock (``crnn_ocr_torch/native/__init__.py::build_lock``).

The JAX CLI and the port's (``--device cpu``) train 2 steps on one
directory of PNG lines (``tests/test_cli.py:33``'s fixture) with the same
flags and seed. The two packages' seeded inits draw different numbers, so
both start from one state: the port's seeded init, saved as a step-0
checkpoint that the port's CLI resumes from (``--resume``), and handed to
the JAX CLI through its ``create_train_state`` (carried into JAX's trees
by the port's weight converter read backwards, and held to the config the
JAX CLI builds). Dropout is 0 (the two dropout streams differ).

Tolerances: the logged losses rtol 2e-5 and the saved running statistics
rtol 2e-4 / atol 2e-5. The saved parameters are held by their updates
from the common initial state (``_assert_updates_close``): at lr 1e-5 an
element moves by at most about 1e-5 a step, inside rtol 2e-4 / atol 2e-5
on the parameter itself, which could not tell a right update from none.
So at least 80 % of each tensor must have moved by more than 0.2 lr, and
the port's update must be JAX's within 1e-2 of it plus 0.1 lr (an ulp of
a parameter near 1 is 0.012 lr), but for a few elements a tensor (at most
2, or 0.5 % of it), each within ``2 * lr`` a step (measured: at most 36
elements of a tensor, 0.11 % of block1's pointwise weights; the largest
share 2 of block0's 576 depthwise weights; the dense, recurrent and
output layers within 0.01 lr). The CLI builds the default backbone (64 to
512 channels, four max-pools): an ulp between XLA's and torch's
convolutions flips a max-pool near-tie now and then, which reroutes a
window's gradient, and Adam's normalized update turns the elements whose
small gradients that changes into steps of up to the learning rate either
way (seen after 2 steps at lr 1e-4: 2 of the stem's 576 weights, 1 of a
BatchNorm's 64 biases, 16 of block0's 8,192 pointwise weights, at most
2e-4 apart; the narrow models of ``tests/test_torch_train.py`` meet no
such tie). Those steps move the second step's loss in proportion to the
rate (2.3e-5 apart at lr 1e-4), so the CLIs run at lr 1e-5. JAX's saved
state is read with the JAX package's own ``CheckpointManager``.
"""

import concurrent.futures
import dataclasses
import json
import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_ocr_torch.cli.predict import main as port_predict
from crnn_ocr_torch.cli.train import main as port_train
from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.infer import init_predictor
from crnn_ocr_torch.infer.weights import params_from_jax
from crnn_ocr_torch.parallel import mesh as mesh_lib
from crnn_ocr_torch.train import CheckpointManager
from crnn_ocr_torch.train.checkpoint import load_model_config
from crnn_ocr_torch.data.synthetic import SyntheticConfig, SyntheticTextlines
from crnn_ocr_torch.train import state as tstate

import native_build_ranks
import torch_dp_ranks

cv2 = pytest.importorskip("cv2")

LR = 1e-5  # the rate of both CLIs (see the module docstring)
STEPS = 2
FLAGS = ["--annotation", "annotation.txt", "--steps", str(STEPS),
         "--eval_every", "100", "--log_every", "1", "--batch_size", "8",
         "--n_units", "16", "--time_dense_size", "16", "--rnn_layers", "1",
         "--val_fraction", "0.25", "--buckets", "64", "--dropout", "0",
         "--lr", str(LR), "--seed", "0"]



@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The models here are tiny: two intra-op threads do their work, and
    leave the machine's other cores to the spawned ranks and to JAX."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


TWO_RANK_FLAGS = ["--dataset", "synthetic", "--buckets", "64", "--steps",
                  "3", "--eval_every", "100", "--log_every", "1",
                  "--batch_size", "8", "--n_units", "8", "--time_dense_size",
                  "8", "--rnn_layers", "1", "--lr", str(LR), "--device",
                  "cpu"]


def _build_twice(build_dir: str, out: str) -> None:
    """Two spawned processes (numpy and the native loader only) run
    ``native_build_ranks.build_worker`` at once; each must exit 0 within
    60 s."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=native_build_ranks.build_worker,
                         args=(r, build_dir, out)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=60)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0, 0]


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """The module's spawns, started before its first test and run while
    the JAX CLI runs: ``--n_devices 2 --device cpu`` (two gloo ranks) and
    two processes loading the native edit distance into one empty build
    directory. Teardown waits for both. The spawned processes take one
    intra-op thread each (``OMP_NUM_THREADS``): the models are tiny."""
    tmp = tmp_path_factory.mktemp("spawned")
    omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    pool = concurrent.futures.ThreadPoolExecutor(2)
    out = {"tmp": tmp,
           "two": pool.submit(port_train, [*TWO_RANK_FLAGS, "--n_devices",
                                           "2", "--save_path",
                                           str(tmp / "two")]),
           "build": pool.submit(_build_twice, str(tmp / "build"),
                                str(tmp))}
    try:
        yield out
    finally:
        pool.shutdown(wait=True)
        if omp is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = omp


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ds")
    synth = SyntheticTextlines(
        SyntheticConfig(alphabet="0123456789", min_len=2, max_len=4))
    rng = np.random.default_rng(0)
    lines = []
    for i in range(24):
        imgs, texts = synth.sample_batch(1, rng)
        name = f"l{i}.png"
        cv2.imwrite(str(d / name), imgs[0])
        lines.append(f"{name}\t{texts[0]}")
    (d / "annotation.txt").write_text("\n".join(lines))
    return str(d)


def _port_init(dataset_dir: str, pdir: str):
    """The port's seeded initial state of the model both CLIs build from
    ``FLAGS`` (the default backbone, f32 on the CPU), saved as a step-0
    checkpoint in ``pdir``; the dataset's size sidecar written once here, so
    that the two CLIs, running at once, only read it."""
    from crnn_ocr_torch.data.reader import Reader, ReaderConfig

    reader = Reader(ReaderConfig(path=dataset_dir,
                                 annotation="annotation.txt",
                                 val_fraction=0.25, buckets=(64,)))
    reader.steps_per_epoch()
    cfg = TorchConfig(num_classes=reader.codec.num_classes, width=64,
                      n_units=16, time_dense_size=16, rnn_layers=1,
                      dropout_rate=0.0)
    state = tstate.create_train_state(cfg, seed=0, device="cpu",
                                      learning_rate=LR)
    CheckpointManager(pdir).save(0, state, cfg, reader.codec)
    return cfg, state.model.state_dict()


def _given_state(port_cfg, sd):
    """A stand-in for ``crnn_ocr_tpu.train.create_train_state`` that holds
    the config the JAX CLI asks for to the port's and returns JAX's train
    state (its optimizer as the CLI asks) holding ``sd``'s weights."""
    from crnn_ocr_tpu.models import CRNN
    from crnn_ocr_tpu.train.state import TrainState, make_optimizer

    def create(cfg, rng, optimizer="adam", learning_rate=1e-3, batch_size=2,
               schedule="constant", total_steps=10_000, warmup_steps=0,
               mesh=None, pallas_interpret=False):
        assert {k: getattr(cfg, k) for k in port_cfg.__dataclass_fields__
                } == dataclasses.asdict(port_cfg), cfg
        params, stats = jax.tree_util.tree_map(jnp.asarray,
                                               torch_dp_ranks.jax_tree(sd))
        return TrainState.create(
            apply_fn=CRNN(cfg=cfg, mesh=mesh).apply, params=params,
            tx=make_optimizer(optimizer, learning_rate, schedule=schedule,
                              total_steps=total_steps,
                              warmup_steps=warmup_steps),
            batch_stats=stats)

    return create


def _losses(save_path: str) -> list:
    with open(os.path.join(save_path, "metrics.jsonl")) as f:
        return [r["loss"] for r in map(json.loads, f) if r["kind"] == "train"]


@pytest.fixture(scope="module", autouse=True)
def cli_runs(background, dataset_dir, tmp_path_factory):
    """Both CLIs from one initial state, run at once (the port's in a
    thread) before the module's first test, beside the background
    spawns."""
    import crnn_ocr_tpu.train as jax_train_pkg
    from crnn_ocr_tpu.cli.train import main as jax_train
    from crnn_ocr_tpu.train import CheckpointManager as JaxCheckpoints

    tmp = tmp_path_factory.mktemp("cli")
    jdir, pdir = str(tmp / "jax"), str(tmp / "port")
    cfg, sd = _port_init(dataset_dir, pdir)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(port_train, ["--path", dataset_dir, *FLAGS,
                                        "--device", "cpu", "--resume",
                                        "--save_path", pdir])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_train_pkg, "create_train_state",
                       _given_state(cfg, sd))
            assert jax_train(["--path", dataset_dir, *FLAGS, "--n_devices",
                              "1", "--save_path", jdir]) == 0
        assert port.result() == 0
    jp, js = JaxCheckpoints(jdir).restore_inference(None, None)
    return {"jax": params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                   jax.tree_util.tree_map(np.asarray, js)),
            "port": CheckpointManager(pdir).restore_inference(),
            "jax_losses": _losses(jdir), "port_losses": _losses(pdir),
            "port_dir": pdir, "init": sd}


def _assert_updates_close(got, want, init, steps, allow):
    """Two runs' saved states from one initial state ``init``: the running
    statistics rtol 2e-4 / atol 2e-5; each parameter's update (its change
    from ``init``), since at lr 1e-5 a whole update lies within the
    parameter tolerance of ``tests/test_torch_train.py``. Most elements
    (80 %) moved by more than twice that check's floor; one run's update
    is the other's within 1e-2 of it plus a tenth of the rate, but for at
    most ``max(count, share * size)`` elements a tensor (``allow``), each
    within ``2 * lr`` a step (see the module docstring)."""
    for name, w in want.items():
        g, w, i = got[name].numpy(), w.numpy(), init[name].numpy()
        if "running" in name:
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5,
                                       err_msg=name)
            continue
        dg, dw = g - i, w - i
        assert (np.abs(dw) > 0.2 * LR).mean() >= 0.8, name
        err = np.abs(dg - dw)
        off = err > 1e-2 * np.abs(dw) + 0.1 * LR
        assert off.sum() <= max(allow[0], allow[1] * off.size), (
            name, int(off.sum()))
        assert np.all(err[off] <= 2 * LR * steps), name


def test_train_cli_matches_jax_cli(cli_runs):
    """Two steps of each CLI from one initial state: the logged losses and
    the saved state (see the module docstring)."""
    np.testing.assert_allclose(cli_runs["port_losses"],
                               cli_runs["jax_losses"], rtol=2e-5)
    assert len(cli_runs["port_losses"]) == STEPS
    got, want = cli_runs["port"], cli_runs["jax"]
    assert sorted(got) == sorted(want)
    _assert_updates_close(got, want, cli_runs["init"], STEPS,
                          allow=(2, 5e-3))


def test_predict_cli_reads_the_trained_model(cli_runs, dataset_dir,
                                             tmp_path):
    out = str(tmp_path / "preds.tsv")
    assert port_predict(["--model", cli_runs["port_dir"], "--image_dir",
                         dataset_dir, "--annotation", "annotation.txt",
                         "--result", out, "--validate", "--beam_width", "4",
                         "--top_paths", "2", "--device", "cpu"]) == 0
    rows = [line.split("\t") for line in open(out).read().splitlines()]
    assert len(rows) == 24 and all(len(r) >= 5 for r in rows)


def test_train_cli_stn_pins_width(tmp_path):
    """``tests/test_cli.py:97``: ``--stn`` trains at a single bucket and
    pins ``ModelConfig.width`` to it; the saved model serves at that
    bucket, narrow and wide requests alike."""
    model_dir = str(tmp_path / "stn_model")
    assert port_train(["--dataset", "synthetic", "--stn", "--buckets", "64",
                       "--steps", "2", "--eval_every", "2", "--batch_size",
                       "4", "--n_units", "8", "--time_dense_size", "8",
                       "--rnn_layers", "1", "--save_path", model_dir,
                       "--device", "cpu"]) == 0
    cfg = json.load(open(os.path.join(model_dir, "model_config.json")))
    assert cfg["use_stn"] and cfg["width"] == 64
    pred = init_predictor(model_dir, device="cpu")
    assert pred.buckets == (64,)
    for w in (30, 300):
        probs, _ = pred.predict_probs([np.full((32, w), 255, np.uint8)])
        assert probs.shape[1] == 64 // 4 - 2


def test_train_cli_two_cpu_ranks_match_one(background):
    """``--n_devices 2 --device cpu`` spawns two gloo ranks, each stepping
    on 4 of every 8 lines with sync-BN, the global dropout draw and the
    gradient sum; its losses equal ``--n_devices 1``'s at rtol 2e-5, and
    its saved state theirs as ``_assert_updates_close`` holds it from the
    seeded initial state, with at most 0.1 % of a tensor off (elements of
    gradients at the f32 noise of their sums, whose Adam step can take
    either sign), and rank 0 alone wrote the metrics."""
    one, two = str(background["tmp"] / "one"), str(background["tmp"] / "two")
    assert port_train([*TWO_RANK_FLAGS, "--n_devices", "1", "--save_path",
                       one]) == 0
    assert background["two"].result() == 0
    np.testing.assert_allclose(_losses(two), _losses(one), rtol=2e-5)
    assert len(_losses(two)) == 3
    init = tstate.create_train_state(load_model_config(one), seed=0,
                                     device="cpu").model.state_dict()
    _assert_updates_close(CheckpointManager(two).restore_inference(),
                          CheckpointManager(one).restore_inference(), init,
                          3, allow=(0, 1e-3))


def test_train_cli_refuses_more_cards_than_present(tmp_path, capsys):
    """Asking for more cards than the machine has exits 2 with
    ``make_mesh``'s message (JAX's), before any training; without CUDA the
    CLI says so and exits 2."""
    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match=(
            f"requested a {n}-device mesh but only "
            f"{torch.cuda.device_count()} devices are "
            "available")):
        mesh_lib.make_mesh(n)
    assert port_train(["--dataset", "synthetic", "--n_devices", str(n),
                       "--save_path", str(tmp_path / "m")]) == 2
    want = (f"requested a {n}-device mesh" if torch.cuda.is_available()
            else "CUDA is not available")
    assert want in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "m")


def test_train_cli_under_torchrun_refuses_without_cuda(tmp_path, capsys,
                                                      monkeypatch):
    """Under ``torchrun``'s environment (``RANK``/``WORLD_SIZE``) the CLI
    still runs on CUDA unless ``--device cpu`` is given: without CUDA it
    says so and exits 2, and joins no process group; ``init_process_mesh``
    with its default device raises likewise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert port_train(["--dataset", "synthetic", "--save_path",
                       str(tmp_path / "m")]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "m")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_lib.init_process_mesh(0, 1, f"file://{tmp_path / 'store'}")
    assert not torch.distributed.is_initialized()


def test_concurrent_native_builds_run_the_compiler_once(background):
    """Two processes that load ``native.load("editdistance")`` into one
    empty build directory at once: g++ runs once, behind the build lock,
    and both load the library."""
    background["build"].result()
    tmp = background["tmp"]
    builds = [json.loads((tmp / f"build{r}.json").read_text())["builds"]
              for r in range(2)]
    assert sorted(len(b) for b in builds) == [0, 1]
    assert [n for b in builds for n in b] == ["editdistance.cc"]
    names = sorted(os.listdir(tmp / "build"))
    assert len(names) == 2 and names[0] == ".lock", names
    assert names[1].startswith("editdistance-") and names[1].endswith(".so")
