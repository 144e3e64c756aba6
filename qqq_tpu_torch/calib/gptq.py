"""Hessian-based GPTQ weight compensation (port of qqq_tpu/calib/gptq.py).

The reference algorithm (QQQ/gptq/gptq.py) in the (K, N) = (in, out)
layout, reference columns being our rows:

* the Hessian ``2/n · Σ xᵀx`` accumulates with running renormalization;
* dead inputs (``H[i, i] = 0``) get ``H[i, i] = 1`` and zero weights;
* group parameters are fixed on the original weights before the loop
  (``static_groups``) and looked up through the act-order permutation
  (descending diag(H), ties kept in index order);
* ``H + 1 % · mean(diag H) · I → chol → inverse → chol(upper)``, in f32;
  where the damped H is not positive definite, ``torch.linalg.cholesky``
  raises (the JAX package's Cholesky returns NaN there);
* rows are quantized one by one inside each 128-row block, each row's
  error fed to the block's later rows, then the block's errors to the rows
  after it with one product.

Every step is an elementwise op or a product of plain PyTorch, so the same
code runs on the card and on the CPU; on the card each 128-row block's row
loop replays one captured CUDA graph.  GPTQ is independent across output
columns: linears that share a Hessian (q/k/v, gate/up) can run as one call
on their weights concatenated along N (``column_loss`` then gives each its
own loss).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from qqq_tpu_torch.core.quant import QuantSpec, find_params_weight


def hessian_init(k: int, device=None) -> Tuple[torch.Tensor, float]:
    return torch.zeros((k, k), dtype=torch.float32, device=device), 0.0


def hessian_update(H: torch.Tensor, nsamples: float, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, float]:
    """One batch of layer inputs ``x`` (…, K): ``H ← H · n/(n + t) +
    2/(n + t) · xᵀx`` with t = the batch's token count, the two factors in
    f32.  Updates ``H`` in place and returns it with the new count."""
    x = x.reshape(-1, x.shape[-1]).to(torch.float32)
    new_n = np.float32(nsamples) + np.float32(x.shape[0])
    H.mul_(float(np.float32(nsamples) / new_n))
    H.addmm_(x.T, x, alpha=float(np.float32(2.0) / new_n))
    return H, float(new_n)


@dataclasses.dataclass
class GPTQResult:
    w_deq: torch.Tensor        # (K, N) f32 fake-quantized weights
    q4: torch.Tensor           # (K, N) int8 signed codes in [-8, 7]
    scale: torch.Tensor        # (G, N) f32
    zero: torch.Tensor         # (G, N) f32
    loss: torch.Tensor         # scalar: Σ (w − q)² / d² / 2 over all rows
    column_loss: torch.Tensor  # (N,) the same sum, per output column


def _cholesky_inv_chain(H: torch.Tensor, percdamp: float) -> torch.Tensor:
    """Damped H → lower Cholesky → inverse → upper Cholesky U of H⁻¹
    (H⁻¹ = UᵀU)."""
    K = H.shape[0]
    eye = torch.eye(K, dtype=H.dtype, device=H.device)
    damp = percdamp * torch.mean(torch.diagonal(H))
    L = torch.linalg.cholesky(H + eye * damp)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    del L, eye
    Hinv = Linv.T @ Linv
    del Linv
    return torch.linalg.cholesky(Hinv, upper=True)


def _quantize_rows(w, s, z, maxq: int, sym_pc: bool):
    """(dequantized, signed code) of rows ``w`` under per-row scales."""
    if sym_pc:
        q = torch.clamp(torch.round(w / s), -maxq, maxq)
        return s * q, q
    q = torch.clamp(torch.round(w / s) + z, 0, maxq)
    return s * (q - z), q - z


def _block_step(Wb, Hb, sb, zb, Err, maxq: int, sym_pc: bool) -> None:
    """Quantize the rows of block ``Wb`` (B, N) in order, in place: after
    the call ``Wb[i]`` holds row i as it was quantized (later rows only
    change rows after them) and ``Err[i]`` its scaled error ``(w − q)/d``."""
    for i in range(Wb.shape[0]):
        w = Wb[i]
        deq, _ = _quantize_rows(w, sb[i], None if sym_pc else zb[i], maxq,
                                sym_pc)
        torch.div(w - deq, Hb[i, i], out=Err[i])
        if i + 1 < Wb.shape[0]:
            Wb[i + 1:].sub_(Hb[i, i + 1:, None] * Err[i])


class _BlockRunner:
    """Runs :func:`_block_step` on each block.  On the card the first block
    runs eagerly and every later one replays a CUDA graph of the same step
    captured after it (its ~10 launches a row then cost no host time), over
    static buffers the block is copied into and out of."""

    def __init__(self, blocksize: int, N: int, maxq: int, sym_pc: bool,
                 device: torch.device):
        self.args = (maxq, sym_pc)
        self.cuda = device.type == "cuda"
        f32 = dict(dtype=torch.float32, device=device)
        self.Err = torch.empty((blocksize, N), **f32)
        if self.cuda:
            self.bufs = (torch.empty((blocksize, N), **f32),
                         torch.empty((blocksize, blocksize), **f32),
                         torch.empty((blocksize, N), **f32),
                         torch.empty((blocksize, N), **f32))
        self.graph = None

    def __call__(self, Wb, Hb, sb, zb) -> torch.Tensor:
        """Quantizes ``Wb`` in place; returns the block's scaled errors."""
        if not self.cuda:
            _block_step(Wb, Hb, sb, zb, self.Err, *self.args)
            return self.Err
        for buf, t in zip(self.bufs, (Wb, Hb, sb, zb)):
            buf.copy_(t)
        if self.graph is not None:
            self.graph.replay()
        else:
            _block_step(*self.bufs, self.Err, *self.args)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                _block_step(*self.bufs, self.Err, *self.args)
        Wb.copy_(self.bufs[0])
        return self.Err


def gptq_quantize_matrix(
    W: torch.Tensor,  # (K, N)
    H: torch.Tensor,  # (K, K) f32
    spec: QuantSpec,
    *,
    blocksize: int = 128,
    percdamp: float = 0.01,
    actorder: bool = True,
    scale_store_dtype: Optional[torch.dtype] = None,
) -> GPTQResult:
    """GPTQ of ``W`` under Hessian ``H``.  ``scale_store_dtype`` (e.g.
    bf16) rounds per-group scales to their storage dtype before any code is
    chosen, so the error feedback compensates the rounding and a packed
    checkpoint dequantizes with exactly the scale GPTQ used."""
    W = W.to(torch.float32).clone()
    K, N = W.shape
    g = K if spec.per_channel else spec.group_size
    if K % blocksize:
        raise ValueError(f"K = {K} is not a multiple of blocksize {blocksize}")

    dead = torch.diagonal(H) == 0
    H = H + torch.diag(dead.to(H.dtype))
    W[dead] = 0.0

    # (G, N), with the arithmetic of the JAX package's jitted GPTQ
    scale_g, zero_g = find_params_weight(W, spec, reciprocal=True)
    if scale_store_dtype is not None and not spec.per_channel:
        scale_g = scale_g.to(scale_store_dtype).to(torch.float32)

    if actorder:
        perm = torch.argsort(-torch.diagonal(H), stable=True)
        W = W[perm]
        H = H[perm][:, perm]
    else:
        perm = torch.arange(K, device=W.device)
    row_group = perm // g

    Hinv = _cholesky_inv_chain(H, percdamp)
    del H

    maxq, sym_pc = spec.maxq, spec.per_channel and spec.sym
    Q_deq = torch.empty_like(W)
    Q_code = torch.empty_like(W)
    column_loss = torch.zeros(N, dtype=torch.float32, device=W.device)
    run_block = _BlockRunner(blocksize, N, maxq, sym_pc, W.device)
    for i1 in range(0, K, blocksize):
        i2 = i1 + blocksize
        Wb = W[i1:i2]  # a view: quantized in place
        sb = scale_g[row_group[i1:i2]]
        zb = zero_g[row_group[i1:i2]]
        Err = run_block(Wb, Hinv[i1:i2, i1:i2], sb, zb)
        Q_deq[i1:i2], Q_code[i1:i2] = _quantize_rows(Wb, sb, zb, maxq, sym_pc)
        column_loss += (Err * Err).sum(dim=0)
        if i2 < K:  # the block's errors to every later row
            W[i2:] -= Hinv[i1:i2, i2:].T @ Err
    column_loss /= 2.0

    invperm = torch.argsort(perm)
    return GPTQResult(
        w_deq=Q_deq[invperm], q4=Q_code[invperm].to(torch.int8),
        scale=scale_g, zero=zero_g, loss=column_loss.sum(),
        column_loss=column_loss,
    )
