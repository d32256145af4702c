"""Data parallelism: meshes, batch sharding and the collectives
(``crnn_ocr_tpu/parallel/mesh.py``).

The JAX package is single-controller GSPMD: the batch is sharded over a
``('data',)`` mesh, the parameters are replicated, XLA inserts the
gradient all-reduce, and every BatchNorm takes global-batch statistics.
The port uses PyTorch's idiom for each half and keeps JAX's names:

* **a process mesh** (``init_process_mesh``) for training: one process per
  device, on ``torch.distributed``. NCCL where each rank has a GPU of its
  own; gloo on the CPU and where ranks share a GPU (NCCL refuses two ranks
  on one card). No ``DistributedDataParallel`` wrapper: its defaults
  average local-mean gradients, keep BatchNorm local and rename every
  state-dict key. The train step sums the gradients itself, in one
  ``all_reduce`` of one flat buffer in the parameters' order
  (``sum_gradients``), and each BatchNorm all-reduces its moments through
  ``all_reduce``, an autograd Function (``models/crnn.py``; the fused
  training stem reduces K8's and K9's sums between its launches,
  ``kernels/fused_stem_train.py``). The port's collectives are
  ``all_reduce`` and ``broadcast`` only, the two that gloo runs on CUDA
  tensors: ``gather_rows`` is an ``all_reduce`` of a zero buffer into which
  each rank writes its own rows.
* **a local mesh** (``make_mesh``) for serving: one process drives a list
  of devices, as JAX's ``Predictor(mesh=)`` does, one model replica a
  distinct device. A device may appear more than once (the CPU tests run a
  mesh of 8 on ``cpu``); a repeated device runs its shards one after
  another.

**The one rule for the loss.** Each rank's loss is the sum of its own rows'
clipped (and, with a ``valid_mask``, masked) losses divided by the global
valid count ``max(sum(mask), 1)`` over the global batch (the global batch
size without a mask), which the host knows before it shards the batch
(``shard_batch`` writes it as ``n_global``). The gradients are then summed
across ranks before the global-norm clip. That is what GSPMD computes for
``sum(loss * mask) / max(sum(mask), 1)`` over the global batch, with no
multiply-by-R, divide-by-R rounding; the reported loss is all-reduced, so
every rank reports the global value.

Ragged batches are padded by ``pad_batch_to`` (pad rows get
``input_length`` 1, ``label_length`` 0 and a 0 in the f32 ``valid_mask``):
the masked mean zeroes their loss and gradient, and the BatchNorms take
masked moments, so a padded step equals the unpadded one.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXIS = "data"  # JAX's mesh axis name, for readers of both packages
DEFAULT_TIMEOUT_S = 300.0  # a collective that waits longer fails


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``('data',)`` mesh. A local mesh holds its ``devices`` (one
    process drives them all); a process mesh holds this rank's device, the
    process ``group``, this process's ``rank`` and the group's ``world``
    size."""

    devices: Tuple[torch.device, ...]
    group: Any = None
    rank: int = 0
    world: int = 1

    @property
    def process(self) -> bool:
        """A process mesh (one rank of a ``torch.distributed`` group)."""
        return self.group is not None

    @property
    def size(self) -> int:
        """The shards a global batch splits into."""
        return self.world if self.process else len(self.devices)

    @property
    def device(self) -> torch.device:
        """This rank's device (a local mesh: its first)."""
        return self.devices[0]

    @property
    def writer(self) -> bool:
        """Whether this process writes checkpoints, logs and events: rank 0
        of a process mesh, and every local mesh."""
        return self.rank == 0

    def rows(self, n_global: int, shard: Optional[int] = None) -> slice:
        """Shard ``shard``'s (default: this rank's) rows of a global batch
        of ``n_global`` rows, which must divide by the mesh."""
        if n_global % self.size:
            raise ValueError(f"a batch of {n_global} rows does not divide "
                             f"over a {self.size}-device mesh")
        b = n_global // self.size
        s = self.rank if shard is None else shard
        return slice(s * b, (s + 1) * b)

    def barrier(self) -> None:
        """Wait for every rank (an ``all_reduce`` of one element, so that
        it runs on every backend and device); a no-op off a process
        mesh."""
        if self.process and self.world > 1:
            t = torch.zeros(1, device=self.device)
            dist.all_reduce(t, group=self.group)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def __repr__(self) -> str:
        kind = (f"process rank {self.rank}/{self.world}" if self.process
                else "local")
        return (f"Mesh({kind}, devices={[str(d) for d in self.devices]}, "
                f"axis={AXIS!r})")


def is_dp(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` is a process mesh of more than one rank: the case in
    which the collectives run."""
    return mesh is not None and mesh.process and mesh.world > 1


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A local mesh over ``devices`` (default: every CUDA device), cut to
    the first ``n_devices`` where given (0 or None: all). Raises JAX's
    message when fewer devices exist."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices]
    if n_devices:
        if n_devices > len(devices):
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} devices are available")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("requested a mesh but no devices are available")
    return Mesh(tuple(devices))


def init_process_mesh(rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      init_method: Optional[str] = None,
                      device="cuda",
                      timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Join (or start) the process group and return this rank's mesh.

    Without ``rank``, from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``);
    otherwise from ``rank``, ``world_size`` and ``init_method`` (a
    ``file://`` store or ``tcp://localhost:<port>``). ``device`` is
    ``cuda`` unless the caller asks for the CPU; a CUDA device without an
    index is ``cuda:<local rank>``, and without CUDA it raises. The backend
    is NCCL on a CUDA device when every local rank can have a card of its
    own, else gloo (the CPU, or ranks sharing a card). A collective that
    waits more than ``timeout_s`` fails: a lost rank raises rather than
    hangs. CPU ranks share the host's cores: each takes its share as
    torch's intra-op threads, unless ``OMP_NUM_THREADS`` sets them (as
    ``torchrun`` does)."""
    if rank is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    if world_size is None or init_method is None:
        raise ValueError("an explicit rank needs world_size and init_method")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    elif "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_world))
    backend = ("nccl" if dev.type == "cuda"
               and torch.cuda.device_count() >= local_world else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh((dev,), group=dist.group.WORLD, rank=dist.get_rank(),
                world=dist.get_world_size())


def close_process_mesh(mesh: Optional[Mesh]) -> None:
    """Leave the process group (where one is initialized)."""
    if mesh is not None and mesh.process and dist.is_initialized():
        dist.destroy_process_group()


# ---- the collectives ----


def _on(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` on the mesh's device (NCCL reduces device tensors only)."""
    return t if t.device == mesh.device else t.to(mesh.device)


class _AllReduce(torch.autograd.Function):
    """``y = sum over ranks of x``; its gradient is the sum over ranks of
    the output's gradient (every rank's loss reads y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of a process mesh, differentiable
    (the port's own Function: ``torch.distributed.nn``'s is deprecated);
    ``x`` itself off a process mesh."""
    if not is_dp(mesh):
        return x
    return _AllReduce.apply(x, mesh.group)


def all_reduce_(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """In-place sum of ``t`` over the ranks of a process mesh (no
    autograd); returns ``t``."""
    if is_dp(mesh):
        buf = _on(t, mesh)
        dist.all_reduce(buf, group=mesh.group)
        if buf is not t:
            t.copy_(buf)
    return t


def broadcast_(t: torch.Tensor, mesh: Optional[Mesh], src: int = 0
               ) -> torch.Tensor:
    """In-place broadcast of rank ``src``'s ``t``; returns ``t``."""
    if is_dp(mesh):
        buf = _on(t, mesh)
        dist.broadcast(buf, src=src, group=mesh.group)
        if buf is not t:
            t.copy_(buf)
    return t


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's rows of ``x`` (equal shards along axis 0), in rank
    order, on every rank: an ``all_reduce`` of a zero buffer into which
    each rank writes its own rows (gloo has no ``all_gather`` of CUDA
    tensors). Booleans go as int32."""
    if not is_dp(mesh):
        return x
    b = x.shape[0]
    dtype = x.dtype
    src = x.to(torch.int32) if dtype == torch.bool else x
    buf = torch.zeros((b * mesh.world,) + tuple(x.shape[1:]),
                      dtype=src.dtype, device=mesh.device)
    buf[mesh.rows(b * mesh.world)] = src.to(mesh.device)
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(device=x.device, dtype=dtype)


def sum_gradients(params: Sequence[torch.nn.Parameter],
                  mesh: Optional[Mesh]) -> None:
    """Sum the parameters' gradients over the ranks: one ``all_reduce`` of
    one flat f32 buffer, in the parameters' order, so every rank adds in
    the same order. Parameters without a gradient are left out (the same
    ones on every rank: they run one graph)."""
    if not is_dp(mesh):
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    all_reduce_(flat, mesh)
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n


def replicate_state(state, mesh: Optional[Mesh]):
    """Every rank takes rank 0's train state: the model's parameters and
    buffers, the optimizer's slots and the step, broadcast from rank 0.
    Returns ``state``."""
    if not is_dp(mesh):
        return state
    with torch.no_grad():
        for t in state.model.state_dict().values():
            broadcast_(t, mesh)
        for p in state.model.parameters():
            for v in state.optimizer.state.get(p, {}).values():
                if torch.is_tensor(v):
                    broadcast_(v, mesh)
    step = torch.tensor([int(state.step)], dtype=torch.int64)
    state.step = int(broadcast_(step, mesh)[0])
    return state


# ---- batches ----


def _is_array(v) -> bool:
    return hasattr(v, "shape") and getattr(v, "ndim", 0) >= 1


def _as_tensor(v, device) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.to(device)
    return torch.from_numpy(np.ascontiguousarray(v)).to(device)


def global_count(batch: Dict[str, Any]) -> float:
    """The rows the loss divides by over a global batch:
    ``max(sum(valid_mask), 1)``, or the batch's rows without a mask."""
    mask = batch.get("valid_mask")
    if mask is not None:
        total = (float(mask.sum().item()) if torch.is_tensor(mask)
                 else float(np.asarray(mask, np.float64).sum()))
        return max(total, 1.0)
    return float(next(v.shape[0] for v in batch.values() if _is_array(v)))


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a global batch, as tensors on the rank's device.
    Arrays with a leading batch axis (numpy or torch) are cut; non-array
    entries (``texts``, ``bucket``) pass through. Adds ``n_global``, the
    global count of ``global_count``."""
    b = next(v.shape[0] for v in batch.values() if _is_array(v))
    rows = mesh.rows(b)
    out = {k: (_as_tensor(v[rows], mesh.device) if _is_array(v)
               and v.shape[0] == b else v) for k, v in batch.items()}
    out["n_global"] = global_count(batch)
    return out


def shard_stacked_batch(stack: Dict[str, Any], mesh: Mesh
                        ) -> Dict[str, Any]:
    """This rank's part of a K-leading stack (``data.pipeline.
    stack_host_batches``): arrays of 2 or more dimensions are cut along the
    batch axis (axis 1), and the K axis and 1-D arrays (``batch_index``)
    stay whole, as JAX's ``P(None, 'data')``; the arrays stay numpy (the
    K-step call uploads them)."""
    out = {}
    for k, v in stack.items():
        if hasattr(v, "shape") and getattr(v, "ndim", 0) >= 2:
            out[k] = v[:, mesh.rows(v.shape[1])]
        else:
            out[k] = v
    return out


def pad_batch_to(batch: Dict[str, Any], size: int) -> Dict[str, Any]:
    """Pad the batch axis up to ``size`` (divisibility for DP sharding),
    as JAX's ``pad_batch_to``: arrays with a leading batch axis gain zero
    rows, ``input_length`` is 1 in the pad rows (their raw loss is ``-log
    p(blank)`` of one frame, not zero), and an f32 ``valid_mask`` marks the
    real rows. numpy batches pad byte for byte as JAX's; torch tensors pad
    on their device. A batch already of ``size`` rows is returned as it
    is."""
    b = next(v.shape[0] for v in batch.values() if _is_array(v))
    if b == size:
        return batch
    pad = size - b
    out = {}
    for k, v in batch.items():
        if _is_array(v) and v.shape[0] == b:
            if torch.is_tensor(v):
                out[k] = torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
            else:
                widths = [(0, pad)] + [(0, 0)] * (v.ndim - 1)
                out[k] = np.pad(np.asarray(v), widths)
        else:
            out[k] = v
    if "input_length" in out:
        il = out["input_length"]
        if torch.is_tensor(il):
            il = il.clone()
        else:
            il = np.asarray(il)
        il[b:] = 1
        out["input_length"] = il
    mask = np.zeros((size,), np.float32)
    mask[:b] = 1.0
    ref = batch.get("x", batch.get("the_labels"))
    out["valid_mask"] = (torch.from_numpy(mask).to(ref.device)
                         if torch.is_tensor(ref) else mask)
    return out


# ---- processes ----


def spawn_ranks(fn, nprocs: int, args: tuple = (),
                timeout_s: Optional[float] = None) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` processes started with the
    ``spawn`` method and wait for all of them. A rank that raises or exits
    non-zero fails the call (the others are terminated); past
    ``timeout_s`` seconds every rank is killed and ``TimeoutError``
    raised. ``fn`` must be importable (defined at a module's top level)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=0.5):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{nprocs} spawned ranks did not finish within "
                    f"{timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
