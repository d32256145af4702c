"""The rank side of ``tests/test_torch_parallel.py``: functions that spawned
processes run (``crnn_ocr_torch.parallel.spawn_ranks``), and ``jax_tree``,
which carries a port state into JAX's trees for the DP tests. This module
imports torch, numpy and the port only, never JAX: each rank joins a gloo
group over a file store in the test's temporary directory, runs the port
on its rows and, beside it, the port's single-device run of the same
global batch, and writes its results to ``<out>/rank<r>.pt`` for the test
process to compare, with JAX's results too."""

from __future__ import annotations

import os

import numpy as np
import torch

from crnn_ocr_torch.data import pipeline as tpipe
from crnn_ocr_torch.infer.weights import params_from_jax, params_to_jax
from crnn_ocr_torch.data.synthetic import SyntheticConfig, SyntheticTextlines
from crnn_ocr_torch.kernels.fused_stem_train import fused_stem_train
from crnn_ocr_torch.parallel import mesh as mesh_lib
from crnn_ocr_torch.train import CheckpointManager
from crnn_ocr_torch.train import loop as tloop
from crnn_ocr_torch.train import state as tstate
from crnn_ocr_torch.train import step as tstep

TIMEOUT_S = 60.0  # a collective waiting longer fails the rank


def jax_tree(sd: dict):
    """JAX's (params, batch_stats) trees of a port state dict: the port's
    ``params_to_jax`` (``params_from_jax`` read backwards), checked to map
    back to ``sd`` exactly."""
    params, stats = params_to_jax(sd)
    back = params_from_jax(params, stats)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    return params, stats


def _mesh(rank: int, world: int, store: str) -> mesh_lib.Mesh:
    mesh = mesh_lib.init_process_mesh(
        rank, world, f"file://{store}", device="cpu", timeout_s=TIMEOUT_S)
    # the test's models are tiny: one intra-op thread a rank does their
    # work with the least of the machine's cores
    torch.set_num_threads(1)
    return mesh


def _snapshot(state) -> dict:
    """The state's tensors (model and optimizer slots) and its step."""
    out = {f"model/{k}": v.detach().clone()
           for k, v in state.model.state_dict().items()}
    names = {p: n for n, p in state.model.named_parameters()}
    for p, slots in state.optimizer.state.items():
        for k, v in slots.items():
            if torch.is_tensor(v):
                out[f"opt/{names[p]}/{k}"] = v.detach().clone()
    out["step"] = torch.tensor(state.step)
    return out


def _steps(cfg, sd, batches, lr, mesh=None, seed=0):
    """Train steps of a fresh state from ``sd`` over ``batches`` (numpy
    dicts; on a mesh each is padded where ragged and sharded), dropout
    drawn as ``fit`` draws it. Returns (metrics per step, snapshot)."""
    state = tstate.create_train_state(cfg, sd, device="cpu",
                                      learning_rate=lr, mesh=mesh)
    step = tstep.make_train_step(cfg, mesh=mesh)
    gen = torch.Generator()
    metrics = []
    for b in batches:
        b = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
        if mesh is not None:
            b = mesh_lib.shard_batch(b, mesh)
        gen.manual_seed(tstep.step_seed(seed, state.step))
        m = step(state, b, gen)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _snapshot(state)


def _stem_sync(mesh, img, conv_w, gamma, beta) -> dict:
    """The training stem's plain versions through ``_FusedStemTrain`` on
    the rank's rows, its K8 and K9 sums reduced over the mesh (on the whole
    batch without one): the global loss ``sum(sin(1.3 * pooled))``
    (all-reduced), the pooled output (gathered), mean, var and the
    gradients (summed, as the train step sums them)."""
    rows = mesh.rows(img.shape[0]) if mesh is not None else slice(None)
    w, g, b = (torch.from_numpy(a).requires_grad_(True)
               for a in (conv_w, gamma, beta))
    pooled, mean, var = fused_stem_train(torch.from_numpy(img[rows]), w, g,
                                         b, 1e-3, mesh)
    loss = torch.sin(pooled * 1.3).sum()
    loss.backward()
    mesh_lib.sum_gradients([w, g, b], mesh)
    return {"loss": mesh_lib.all_reduce_(loss.detach().clone(), mesh),
            "pooled": mesh_lib.gather_rows(pooled.detach(), mesh),
            "mean": mean, "var": var, "d_w": w.grad, "d_gamma": g.grad,
            "d_beta": b.grad}


def _fit_resume(mesh, cfg, work: str) -> dict:
    """``fit`` over batches of 11 lines (padded to the mesh), with an
    evaluation and a checkpoint every step: a straight 2-step run, and a
    1-step run restored into a fresh state and fitted on to 2 from the
    stream's batch 1. Counts the checkpoint writes of this rank."""
    synth = SyntheticTextlines(SyntheticConfig(alphabet="0123456789",
                                               min_len=2, max_len=4))
    writes = []
    real_save = CheckpointManager._save

    def counted(self, *a, **kw):
        writes.append(a[0])
        return real_save(self, *a, **kw)

    CheckpointManager._save = counted

    def stream(skip, steps):
        return tpipe.device_batches(tpipe.synthetic_batches(
            batch_size=11, bucket=64, seed=1, steps=steps, synth=synth,
            skip=skip), "cpu", cfg, prefetch=0)

    def run(steps, skip, d, state):
        return tloop.fit(state, cfg, stream(skip, steps), lambda: stream(
            0, 1), synth.codec, tloop.FitConfig(
                steps=steps, eval_every=1, eval_batches=1, log_every=1,
                checkpoint_dir=d, metrics_path=os.path.join(d, "m.jsonl"),
                seed=3, mesh=mesh))

    try:
        fresh = lambda: tstate.create_train_state(  # noqa: E731
            cfg, seed=5, device="cpu", learning_rate=3e-3, mesh=mesh)
        straight = run(2, 0, os.path.join(work, "straight"), fresh())
        part = os.path.join(work, "part")
        run(1, 0, part, fresh())
        resumed = CheckpointManager(part).restore(fresh())
        resumed_step = resumed.step
        resumed = run(2, 1, part, resumed)
    finally:
        CheckpointManager._save = real_save
    return {"straight": _snapshot(straight), "resumed": _snapshot(resumed),
            "resumed_from": resumed_step, "writes": writes}


def dp_worker(rank: int, world: int, store: str, inputs: str,
              out: str) -> None:
    """Two ranks: the DP step, the padded DP step, dropout, the training
    stem's reductions and ``fit`` with a resume (see the test)."""
    torch.manual_seed(0)
    x = torch.load(inputs, weights_only=False)
    mesh = _mesh(rank, world, store)
    try:
        res = {"rank": rank}
        cfg, sd, lr = x["cfg"], x["sd"], x["lr"]
        res["dp"] = _steps(cfg, sd, [x["batch"]], lr, mesh)
        res["padded_dp"] = _steps(cfg, sd, [x["padded"]], lr, mesh)
        drop = x["drop_cfg"]
        res["dropout_dp"] = _steps(drop, sd, x["drop_batches"], lr, mesh)
        res["stem"] = _stem_sync(mesh, *x["stem"])
        if rank == 0:  # the single-device runs, once
            res["dropout_single"] = _steps(drop, sd, x["drop_batches"], lr)
            res["stem_single"] = _stem_sync(None, *x["stem"])
        res["fit"] = _fit_resume(mesh, x["fit_cfg"], x["work"])
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        mesh_lib.close_process_mesh(mesh)


def cached_worker(rank: int, world: int, store: str, inputs: str,
                  out: str) -> None:
    """Four ranks: the device corpus's K = 2 calls and the streamed K = 2
    stacks on the mesh, against the same calls on one device."""
    from crnn_ocr_torch.data.device_cache import DeviceResidentCorpus
    from crnn_ocr_torch.data.reader import Reader, ReaderConfig

    x = torch.load(inputs, weights_only=False)
    mesh = _mesh(rank, world, store)
    try:
        cfg, sd, lr, seed = x["cfg"], x["sd"], x["lr"], x["seed"]
        reader = Reader(ReaderConfig(path=x["path"], **x["reader"]))
        # the test packed the corpus: no rank writes it
        corpus = DeviceResidentCorpus(reader, device="cpu", mesh=mesh)
        res = {"rank": rank}
        # the single-device run once, on rank 0 (the others wait for it at
        # the DP run's first collective)
        for name, m in ((("single", None),) if rank == 0 else ()) + (
                ("dp", mesh),):
            state = tstate.create_train_state(cfg, sd, device="cpu",
                                              learning_rate=lr, mesh=m)
            kw = dict(augment=True, augment_seed=seed, mesh=m)
            cached = tstep.make_cached_multi_train_step(cfg, **kw)
            losses = []
            for stack in corpus.stacked_index_batches(2, epochs=1):
                a = corpus.arrays(stack["bucket"])
                ms = cached(state, a["pixels"], a["widths"], a["labels"],
                            a["lab_len"], stack["rows"],
                            stack["batch_index"], seed, stack["bucket"])
                losses.append(ms["loss"])
            multi = tstep.make_multi_train_step(cfg, **kw)
            for stack in tpipe.stack_host_batches(
                    reader.run_generator(epochs=1), 2, prefetch=0):
                if "stacked" not in stack:
                    continue
                if m is not None:
                    stack = mesh_lib.shard_stacked_batch(stack, m)
                losses.append(multi(state, stack, seed,
                                    stack["bucket"])["loss"])
            res[name] = {"losses": torch.cat(losses),
                         "state": _snapshot(state)}
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        mesh_lib.close_process_mesh(mesh)
