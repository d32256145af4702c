"""Bidirectional GRU (``crnn_ocr_tpu/models/rnn.py:41-190``).

The input projection of every step and both directions is one batched
matmul with f32 products and sums, plus the input bias; the recurrence goes
to ``kernels.bigru`` (the CUDA kernel on the card, its plain version on the
CPU). Semantics follow the JAX package's Pallas branch (``rnn.py:119-167``):
the projections are cast to the compute dtype before the recurrence, and
the hidden state is carried in f32.

Parameters keep the JAX layout, which the kernel consumes: ``kernel``
(2, F, 3H), ``recurrent_kernel`` (2, H, 3H), ``bias`` (2, 2, 3H) with
``bias[:, 0]`` the input bias and ``bias[:, 1]`` the recurrent one (Keras
``reset_after``), gate order z|r|h. The kernel's own layout of the
recurrent kernel (``kernels.bigru.kernel_weights``) is built from the
current weights on every call in training mode, where an optimizer changes
them between calls; in eval mode it is the cached buffer ``u_kernel``,
rebuilt whenever a state dict is loaded and whenever the module enters eval
mode. Gradients reach ``kernel``, ``recurrent_kernel`` and ``bias``.
"""

from __future__ import annotations

import torch
from torch import nn

from crnn_ocr_torch.kernels.bigru import bigru, kernel_weights


class _MatmulF32(torch.autograd.Function):
    """bf16 ``a @ b`` with an f32 result. ``torch.bmm(..., out_dtype=)``
    has no autograd formula, so the backward is written out: the f32
    cotangent times the other operand widened to f32, each gradient cast to
    its operand's dtype (as JAX transposes a dot with
    ``preferred_element_type=f32``)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` with an f32 result whose products and sums are f32.
    bf16 operands keep their values: on the card through ``bmm`` with an
    f32 output, on the CPU by widening them first (bf16 products are exact
    in f32, so the two agree up to summation order)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return _MatmulF32.apply(a, b)


class BiRNN(nn.Module):
    """Bidirectional GRU, outputs of the two directions concatenated.
    (B, T, F) -> (B, T, 2 * units)."""

    def __init__(self, in_features: int, units: int, cell: str = "gru",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cell != "gru":
            raise NotImplementedError(
                f"rnn_cell={cell!r}: the LSTM recurrence is not ported yet "
                "(kernels/bigru.py::bilstm_pallas_raw is still to port)"
            )
        self.units = units
        self.dtype = dtype
        g = 3 * units
        self.kernel = nn.Parameter(torch.zeros(2, in_features, g))
        self.recurrent_kernel = nn.Parameter(torch.zeros(2, units, g))
        self.bias = nn.Parameter(torch.zeros(2, 2, g))
        self._refresh_u_kernel()
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module._refresh_u_kernel())

    @torch.no_grad()
    def _refresh_u_kernel(self) -> None:
        self.register_buffer(
            "u_kernel", kernel_weights(self.recurrent_kernel.to(self.dtype)),
            persistent=False)

    def train(self, mode: bool = True):
        super().train(mode)
        if not mode:  # the weights may have changed since the last build
            self._refresh_u_kernel()
        return self

    def kernel_operand(self) -> torch.Tensor:
        """U in the layout the card's kernel reads: built from the current
        weights in training mode, the cached buffer in eval mode."""
        if self.training:
            with torch.no_grad():
                return kernel_weights(self.recurrent_kernel.to(self.dtype))
        return self.u_kernel

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, F) -> the recurrence's input xw (T, 2, B, 3H) in the
        compute dtype: the input projections plus the input bias, direction
        1 time-reversed."""
        B, T, F = x.shape
        xt = x.to(self.dtype).transpose(0, 1)  # (T, B, F)
        # (2, T*B, F): direction 0 forward, direction 1 time-reversed
        x2 = torch.stack([xt, xt.flip(0)]).reshape(2, T * B, F)
        xw = matmul_f32(x2, self.kernel.to(self.dtype))
        xw = xw + self.bias[:, 0, None, :]
        return xw.reshape(2, T, B, -1).transpose(0, 1).to(self.dtype) \
            .contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hs = bigru(self.project(x), self.recurrent_kernel.to(self.dtype),
                   self.bias[:, 1], self.kernel_operand())  # (T, 2, B, H)
        out = torch.cat([hs[:, 0], hs[:, 1].flip(0)], dim=-1)  # (T, B, 2H)
        return out.transpose(0, 1)
