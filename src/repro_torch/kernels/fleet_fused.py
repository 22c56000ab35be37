"""Fused block-pruned client gradients for the layer-structured MLP.

The fleet round's hot path, per client c: prune the global model at
rho_c with block-tile keeps, run forward and backward on the pruned
model, re-mask the gradient and add it with the Eq.-(5) weight.  Only
the weighted gradient **sum** and the per-client losses leave the call;
the (clients, params) gradient batch is never formed.

Replaces the Pallas kernel ``repro/kernels/fleet_fused.py::
fused_grads_pallas``; its semantics are those of ``fused_grads_xla``:

* ``fused_grads_plain`` repeats ``fused_grads_xla`` in plain PyTorch (the
  tile loop with keeps folded into the short-producer operand) and is what
  runs on the CPU, at any float dtype;
* the CUDA kernel (``csrc/fleet_fused.cu``) runs on the card, float32
  only.  The Pallas kernel summed dW across a sequential grid in VMEM;
  blocks on Hopper run in parallel, so the kernel runs row-parallel passes
  (forward, loss, back-propagated dz into a per-row workspace) and then
  output-tile-parallel dW passes over fixed row segments, summed in order.
  No float atomics: the result repeats bit for bit.  At the slice (10,000
  clients x batch 8, 784-60-20-10) the call is compute-bound: ~15.7 GFLOP
  of float32 FMA, 94% of it in the input layer.  That layer's forward and
  dW passes (``wide_rows_kernel``, ``wide_dw_kernel``) stage their operands
  by cp.async into a ring and give each thread an 8 x 4 register tile; the
  narrow layers keep the first design's 4 x 4 passes.

``fused_fleet_grads`` is the wrapper: the kernel for CUDA tensors (counted
in ``fused_fleet_grads.launches``, one per call; the csrc kernel and pass
of each of the call's launches in ``fused_fleet_grads.last_passes``, its
client count in ``last_clients``), the plain version for CPU tensors.

``reference_grads`` is the reference's vmap oracle (``masked_client_grads``
under ``block_masks``): per-client autodiff at the pruned point with
``torch.func``, which forms the (clients, params) gradient batch.  It is
no Pallas kernel and has none here; the fleet engine's
``kernel="reference"`` path runs ``masked_client_grads``.

``masked_scan_grads`` is the generic tasks' fused path (the reference's
``lax.scan`` of the same name, no Pallas kernel either): the same
weighted sum of block-pruned gradients for any ``loss_fn``, with autodiff
over bounded blocks of clients and the sum taken client by client in
index order, so no (clients, params) batch beyond a block is formed.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.core import pruning
from repro_torch.kernels import block_sparse_matmul as _bsm
from repro_torch.kernels import build
from repro_torch.models import mlp

__all__ = ["layer_weights", "grads_tree", "layer_norm_states", "layer_keeps",
           "fused_grads_plain", "fused_fleet_grads", "segments",
           "masked_client_grads", "weighted_sum", "reference_grads",
           "masked_scan_grads", "scan_block"]

# dW row segments per layer, fixed so the sum order is fixed: at the slice's
# 80,000 rows the input layer's 7 x 150 dW CTAs fill 4 waves of 2 CTAs on
# each of an H100's 132 SMs
_SEGMENTS = 150
_ROWS_STAGED = 32  # rows a dW pass stages per step (csrc RC and DR)


def layer_weights(params: dict) -> tuple[list[torch.Tensor],
                                         list[torch.Tensor]]:
    """Params -> ([w_0..w_L-1], [b_0..b_L-1]) in layer order (explicit
    ``layer{i}`` keys, not sorted-key order, which puts ``layer10``
    before ``layer2``)."""
    n = len(params)
    return ([params[f"layer{i}"]["w"] for i in range(n)],
            [params[f"layer{i}"]["b"] for i in range(n)])


def grads_tree(layer_grads: Sequence[tuple[torch.Tensor, torch.Tensor]]
               ) -> dict:
    """[(dw, db), ...] in layer order -> params-shaped dict."""
    return {f"layer{i}": {"w": dw, "b": db}
            for i, (dw, db) in enumerate(layer_grads)}


def layer_norm_states(params: dict, block: int
                      ) -> list[pruning.BlockNormState]:
    """One ``BlockNormState`` per weight matrix, in layer order; computed
    once per round, every layer's tile norms in one launch."""
    ws, _ = layer_weights(params)
    return pruning.block_norm_state(ws, block)


def layer_keeps(states: Sequence[pruning.BlockNormState],
                rates: torch.Tensor) -> list[torch.Tensor]:
    """Per-layer tile keeps ``(clients, Tk, Tn)`` for a batch of rates."""
    return [pruning.block_keep([st], rates)[0] for st in states]


def _tile_slices(dim: int, block: int) -> list[tuple[int, int]]:
    return [(s, min(s + block, dim)) for s in range(0, dim, block)]


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path; the kernel's yardstick on the card)
# ---------------------------------------------------------------------------

def fused_grads_plain(params: dict, x: torch.Tensor, y: torch.Tensor,
                      keeps: Sequence[torch.Tensor], weights: torch.Tensor,
                      block: int) -> tuple[dict, torch.Tensor]:
    """Weighted-sum block-pruned gradients + per-client losses.

    Args:
      params: the dense global model, ``{"layer{i}": {"w", "b"}}``.
      x: (clients, batch, dim) local batches; y: (clients, batch) labels.
      keeps: per-layer (clients, Tk, Tn) tile keeps (``layer_keeps``).
      weights: (clients,) Eq.-(5) weights (zero drops the client).
      block: pruning tile edge.

    Returns ``(grad_wsum, losses)``: the params-shaped weighted gradient
    sum and the (clients,) unweighted training losses.
    """
    ws, bs = layer_weights(params)
    nl = len(ws)
    c, batch, _ = x.shape
    rows = c * batch
    dev = x.device
    yf = y.reshape(-1).long()

    acts3, zs, kexp_cache = [x], [], []
    for l in range(nl):
        kdim, ndim = ws[l].shape
        ksizes = torch.tensor([k1 - k0 for k0, k1 in _tile_slices(kdim, block)],
                              device=dev)
        kexps, cols = [], []
        for uj, (n0, n1) in enumerate(_tile_slices(ndim, block)):
            kexp = torch.repeat_interleave(keeps[l][:, :, uj], ksizes, dim=1,
                                           output_size=kdim)
            kexps.append(kexp)
            xs = (acts3[-1] * kexp[:, None, :]).reshape(rows, kdim)
            cols.append(xs @ ws[l][:, n0:n1])
        z = torch.cat(cols, dim=-1) + bs[l]
        zs.append(z)
        a_next = torch.relu(z) if l < nl - 1 else z
        acts3.append(a_next.reshape(c, batch, ndim))
        kexp_cache.append(kexps)

    logp = torch.log_softmax(zs[-1], dim=-1)
    nll = -torch.gather(logp, 1, yf[:, None])[:, 0]
    losses = nll.reshape(c, batch).mean(dim=-1)
    onehot = (yf[:, None] == torch.arange(logp.shape[-1], device=dev)
              ).to(logp.dtype)
    dz = (torch.exp(logp) - onehot) / batch
    w_rows = torch.repeat_interleave(weights, batch, output_size=rows)

    layer_grads: list = [None] * nl
    for l in reversed(range(nl)):
        kdim, ndim = ws[l].shape
        nsizes = torch.tensor([n1 - n0 for n0, n1 in _tile_slices(ndim, block)],
                              device=dev)
        dzw3 = (dz * w_rows[:, None]).reshape(c, batch, ndim)
        a2 = acts3[l].reshape(rows, kdim)
        dw_rows = []
        for ti, (k0, k1) in enumerate(_tile_slices(kdim, block)):
            kexpn = torch.repeat_interleave(keeps[l][:, ti, :], nsizes, dim=1,
                                            output_size=ndim)
            dzm = (dzw3 * kexpn[:, None, :]).reshape(rows, ndim)
            dw_rows.append(a2[:, k0:k1].T @ dzm)
        dw = torch.cat(dw_rows, dim=0)
        db = torch.sum(dzw3.reshape(rows, ndim), dim=0)
        layer_grads[l] = (dw, db)
        if l > 0:
            da3 = None
            for uj, (n0, n1) in enumerate(_tile_slices(ndim, block)):
                part = (dz[:, n0:n1] @ ws[l][:, n0:n1].T) \
                    .reshape(c, batch, kdim) * kexp_cache[l][uj][:, None, :]
                da3 = part if da3 is None else da3 + part
            dz = da3.reshape(rows, kdim) * (zs[l - 1] > 0)
    return grads_tree(layer_grads), losses


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = build.load("fleet_fused")
    if lib.ff_loss.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ff_masked_rows.argtypes = [p] * 6 + [i] * 7 + [p]
        lib.ff_loss.argtypes = [p] * 4 + [i] * 3 + [p]
        lib.ff_dw_partial.argtypes = [p] * 5 + [i] * 7 + [p]
        lib.ff_wide_rows.argtypes = [p] * 5 + [i] * 6 + [p]
        lib.ff_wide_dw.argtypes = [p] * 5 + [i] * 7 + [p]
        lib.ff_reduce.argtypes = [p, p, i, ctypes.c_int64, p]
        for fn in (lib.ff_masked_rows, lib.ff_loss, lib.ff_dw_partial,
                   lib.ff_wide_rows, lib.ff_wide_dw, lib.ff_reduce):
            fn.restype = ctypes.c_int
    return lib


def segments(rows: int) -> tuple[int, int]:
    """(rows a segment, segments) of the dW passes: fixed by the row count
    alone, so the sum order, and the bits, do not depend on the card."""
    seg_rows = max(_ROWS_STAGED, -(-rows // _SEGMENTS))
    return seg_rows, -(-rows // seg_rows)


def _check_shapes(ws, bs, x, y, keeps, weights, block) -> None:
    """Raise unless the operands have the shapes the call documents (the
    kernel would read a mis-shaped operand out of bounds)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (clients, batch, dim), got {tuple(x.shape)}")
    c, batch, d = x.shape
    if tuple(y.shape) != (c, batch):
        raise ValueError(f"y must be {(c, batch)}, got {tuple(y.shape)}")
    if tuple(weights.shape) != (c,):
        raise ValueError(f"weights must be {(c,)}, got {tuple(weights.shape)}")
    if len(keeps) != len(ws):
        raise ValueError(f"{len(ws)} layers but {len(keeps)} keeps")
    for l, (w, b, k) in enumerate(zip(ws, bs, keeps)):
        kdim, ndim = w.shape
        if kdim != (d if l == 0 else ws[l - 1].shape[1]):
            raise ValueError(f"layer{l}/w {tuple(w.shape)} does not chain")
        if tuple(b.shape) != (ndim,):
            raise ValueError(f"layer{l}/b must be {(ndim,)}, got "
                             f"{tuple(b.shape)}")
        grid = (c, -(-kdim // block), -(-ndim // block))
        if tuple(k.shape) != grid:
            raise ValueError(f"layer {l} keeps must be {grid}, got "
                             f"{tuple(k.shape)}")


def _check_operands(ws, bs, x, y, keeps, weights, block) -> None:
    if block % 4 or 32 % block:
        raise ValueError(f"the fused kernel takes a pruning block in "
                         f"(4, 8, 16, 32), got {block}")
    for t in list(ws) + list(bs) + list(keeps) + [x, y, weights]:
        if not t.is_cuda or t.device != x.device:
            raise ValueError("fused kernel operands must all lie on one "
                             "CUDA device")
    for t in list(ws) + list(bs) + list(keeps) + [x, weights]:
        if t.dtype != torch.float32:
            raise TypeError(f"the fused kernel takes float32, got {t.dtype}")


def _fused_cuda(params, x, y, keeps, weights, block):
    ws, bs = layer_weights(params)
    _check_operands(ws, bs, x, y, keeps, weights, block)
    nl = len(ws)
    c, batch, d = x.shape
    rows = c * batch
    dev = x.device
    ws = [w.contiguous() for w in ws]
    bs = [b.contiguous() for b in bs]
    keeps = [k.contiguous() for k in keeps]
    weights = weights.contiguous()
    y64 = y.reshape(-1).to(torch.int64).contiguous()
    lib = _lib()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    ptr = build.ptr
    null = ctypes.c_void_p(None)
    passes = []

    def run(fn, kernel, label, *args):
        build.check(lib, fn(*args, stream), f"{fn.__name__}({label})")
        passes.append((kernel, label))

    acts = [x.reshape(rows, d).contiguous()]
    for l in range(nl):
        kdim, ndim = ws[l].shape
        z = torch.empty((rows, ndim), dtype=torch.float32, device=dev)
        if l == 0:
            run(lib.ff_wide_rows, "wide_rows_kernel", "forward L0",
                ptr(acts[-1]), ptr(ws[0]), ptr(keeps[0]), ptr(bs[0]), ptr(z),
                rows, kdim, ndim, batch, block, int(nl > 1))
        else:
            run(lib.ff_masked_rows, "masked_rows_kernel", f"forward L{l}",
                ptr(acts[-1]), ptr(ws[l]), ptr(keeps[l]), ptr(bs[l]), null,
                ptr(z), rows, kdim, ndim, batch, block, int(l < nl - 1), 0)
        acts.append(z)

    n_classes = ws[-1].shape[1]
    dz = torch.empty((rows, n_classes), dtype=torch.float32, device=dev)
    losses = torch.empty((c,), dtype=torch.float32, device=dev)
    run(lib.ff_loss, "loss_kernel", "loss", ptr(acts[-1]), ptr(y64), ptr(dz),
        ptr(losses), c, batch, n_classes)

    seg_rows, nseg = segments(rows)
    layer_grads: list = [None] * nl
    for l in reversed(range(nl)):
        kdim, ndim = ws[l].shape
        partial = torch.empty((nseg, kdim + 1, ndim), dtype=torch.float32,
                              device=dev)
        dw_pass = ((lib.ff_wide_dw, "wide_dw_kernel") if l == 0 else
                   (lib.ff_dw_partial, "dw_partial_kernel"))
        run(*dw_pass, f"dW L{l}", ptr(acts[l]), ptr(dz), ptr(weights),
            ptr(keeps[l]), ptr(partial), rows, kdim, ndim, batch, block,
            seg_rows, nseg)
        summed = torch.empty((kdim + 1, ndim), dtype=torch.float32,
                             device=dev)
        run(lib.ff_reduce, "reduce_segments_kernel", f"reduce L{l}",
            ptr(partial), ptr(summed), nseg, (kdim + 1) * ndim)
        layer_grads[l] = (summed[:kdim], summed[kdim])
        if l > 0:
            dz_prev = torch.empty((rows, kdim), dtype=torch.float32,
                                  device=dev)
            run(lib.ff_masked_rows, "masked_rows_kernel", f"backward L{l}",
                ptr(dz), ptr(ws[l]), ptr(keeps[l]), null, ptr(acts[l]),
                ptr(dz_prev), rows, ndim, kdim, batch, block, 0, 1)
            dz = dz_prev
    fused_fleet_grads.last_passes = tuple(passes)
    return grads_tree(layer_grads), losses


def fused_fleet_grads(params: dict, x: torch.Tensor, y: torch.Tensor,
                      keeps: Sequence[torch.Tensor], weights: torch.Tensor,
                      block: int) -> tuple[dict, torch.Tensor]:
    """Weighted-sum pruned gradients + per-client losses (see
    ``fused_grads_plain`` for the arguments).  A CUDA ``x`` launches the
    kernel (float32 only; anything else raises); a CPU ``x`` runs the plain
    version.  Mis-shaped operands raise on either."""
    _check_shapes(*layer_weights(params), x, y, keeps, weights, block)
    c = x.shape[0]
    if not x.is_cuda:
        return fused_grads_plain(params, x, y, keeps, weights, block)
    out = _fused_cuda(params, x, y, keeps, weights, block)
    fused_fleet_grads.launches += 1
    fused_fleet_grads.last_clients = c
    return out


fused_fleet_grads.launches = 0
# (csrc kernel name, pass) of each launch of the last kernel call, in order
fused_fleet_grads.last_passes = ()
# the client count of the last kernel call
fused_fleet_grads.last_clients = 0


# ---------------------------------------------------------------------------
# vmap + autodiff oracle
# ---------------------------------------------------------------------------

def masked_client_grads(loss_fn, params: dict, masks: dict, batch: dict
                        ) -> tuple[torch.Tensor, dict]:
    """Per-client ``(losses, grads)``: client c's gradient of
    ``loss_fn(params, batch)`` at ``params * masks[c]`` on ``batch[c]``,
    re-masked.  Every mask leaf leads with the client axis (what the mask
    builders give for a batch of rates); ``torch.func.vmap`` runs the
    clients as one batch."""
    pruned = pruning.apply_masks(params, masks)

    def one(p, b):
        g, loss = torch.func.grad_and_value(loss_fn)(p, b)
        return loss, g

    losses, grads = torch.func.vmap(one)(pruned, batch)
    return losses, pruning.apply_masks(grads, masks)


def weighted_sum(weights: torch.Tensor, grads: dict) -> dict:
    """sum_c weights[c] grads[c], leaf by leaf, in the promoted dtype of
    the weights and the leaf."""
    def one(g):
        dt = torch.promote_types(weights.dtype, g.dtype)
        return torch.tensordot(weights.to(dt), g.to(dt), dims=1)
    return pruning.tree_map(one, grads)


def reference_grads(params: dict, x: torch.Tensor, y: torch.Tensor,
                    rho: torch.Tensor, weights: torch.Tensor, block: int
                    ) -> tuple[dict, torch.Tensor]:
    """The oracle of ``fused_fleet_grads``: per-client ``block_masks`` at
    rho, autodiff at the pruned point, re-masked, weighted sum.  Returns
    ``(grad_wsum, losses)``; forms the (clients, params) batch."""
    masks = pruning.block_masks(params, rho, block)
    losses, grads = masked_client_grads(
        lambda p, b: mlp.classifier_loss(p, b["x"], b["y"]), params, masks,
        {"x": x, "y": y})
    return weighted_sum(weights, grads), losses


# ---------------------------------------------------------------------------
# Generic task path: the Eq.-(5) sum for any loss, over bounded client blocks
# ---------------------------------------------------------------------------

# the working set a block of clients may hold: a pruned copy of the
# params, their gradient, the weighted gradient and the element masks
# (4 param-sized buffers a client)
_SCAN_BLOCK_BYTES = 2 << 30


def _block_capacity(params) -> int:
    """Clients that fit ``_SCAN_BLOCK_BYTES`` at four param-sized buffers
    each."""
    nbytes = sum(leaf.numel() * leaf.element_size()
                 for leaf in pruning.flatten(params))
    return _SCAN_BLOCK_BYTES // max(4 * nbytes, 1)


def scan_block(params, clients: int) -> int:
    """Clients a ``masked_scan_grads`` block takes: as many as fit
    ``_SCAN_BLOCK_BYTES`` (at least 1, at most ``clients``)."""
    return max(1, min(clients, _block_capacity(params)))


def masked_scan_grads(loss_fn, params, batch, keeps: Sequence,
                      weights: torch.Tensor, block):
    """Weighted sum of block-pruned gradients for an arbitrary task.

    Client c's gradient of ``loss_fn(params * M_c, batch[c])`` at the
    pruned point, re-masked by M_c, weighted by ``weights[c]`` and added
    to the sum; M_c comes from the tile keeps ``keeps`` (per leaf in
    ``pruning.flatten`` order, leading dim clients, ``None`` for
    unprunable leaves), expanded on each leaf's own grid ``block`` (int,
    pair or per-leaf list, see ``pruning.leaf_blocks``).

    Clients go through in blocks of ``scan_block`` clients, a block's
    gradients by ``torch.func.vmap`` of ``grad_and_value``.  A model too
    large for two clients a block goes client by client through plain
    autograd (it gains nothing from batching, and the transforms'
    dispatch costs more per op than its kernels).  The sum adds one
    client at a time in index order, as the reference's scan carries it,
    so it repeats bit for bit; on the CPU the block size changes no bit
    either (on the card, batched products of two block sizes may round
    apart).  The sum accumulates in ``promote_types(weights.dtype,
    float32)`` promoted with each leaf's dtype.  Returns ``(grad_wsum,
    losses)``: the params-shaped weighted sum and the (clients,)
    unweighted losses.
    """
    leaves, flags = pruning._flatten_prunable(params)
    blocks = pruning.leaf_blocks(flags, block)
    prunable = [i for i, f in enumerate(flags) if f]
    acc_dtype = torch.promote_types(weights.dtype, torch.float32)
    acc = [torch.zeros(w.shape, dtype=torch.promote_types(w.dtype, acc_dtype),
                       device=w.device) for w in leaves]
    n = weights.shape[0]
    alone = _block_capacity(params) < 2
    step = scan_block(params, n)

    def pruned_at(masks):
        pruned = list(leaves)
        for i, m in zip(prunable, masks):
            pruned[i] = torch.where(m, leaves[i], 0.0)
        return pruned

    def remasked(g, masks):
        g = list(g)
        for i, m in zip(prunable, masks):
            g[i] = torch.where(m, g[i], 0.0)
        return g

    def one(masks, batch_i):
        def loss_of(ws):
            return loss_fn(pruning.unflatten(params, ws), batch_i)
        g, loss = torch.func.grad_and_value(loss_of)(pruned_at(masks))
        return remasked(g, masks), loss

    def single(masks, batch_i):
        (loss, _), g = pruning.value_and_grad(
            lambda ws: (loss_fn(pruning.unflatten(params, ws), batch_i),
                        None), pruned_at(masks))
        return [gi[None] for gi in remasked(g, masks)], loss[None]

    losses = []
    for j in range(0, n, step):
        k = min(j + step, n)
        masks = [_bsm.expand_mask(keeps[i][j:k] > 0, leaves[i].shape,
                                  *blocks[i]) for i in prunable]
        if alone:
            g, loss = single([m[0] for m in masks],
                             pruning.tree_map(lambda a: a[j], batch))
        else:
            g, loss = torch.func.vmap(one)(
                masks, pruning.tree_map(lambda a: a[j:k], batch))
        w = weights[j:k]
        for lf, gl in enumerate(g):
            wg = w.reshape((-1,) + (1,) * (gl.ndim - 1)) * gl
            for c in range(k - j):
                acc[lf] = acc[lf] + wg[c]
        losses.append(loss)
    return pruning.unflatten(params, acc), torch.cat(losses)
