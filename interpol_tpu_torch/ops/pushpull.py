"""The generic path: pull, push, count, grad, pushgrad and hess on any
grid, as ``torch.autograd.Function``s with hand-wired adjoints.

PyTorch port of ``interpol_tpu/ops/pushpull.py:69-246``, rule for rule.
Each backward is composed from the Functions themselves,

    pull     : d_inp = push(ct)          d_grid = sum_C grad(inp) . ct
    push     : d_inp = pull(ct)          d_grid = sum_C grad(ct) . inp
    count    :                           d_grid = sum_C grad(ct)
    grad     : d_inp = pushgrad(ct)      d_grid = sum_{C,D2} hess(inp) . ct
    pushgrad : d_inp = grad(ct)          d_grid = sum_{C,D2} hess(ct) . inp
    hess     : d_inp = pushhess(ct)      d_grid = VJP of the plain hess

so under ``create_graph=True`` a second backward re-enters the Functions,
and so the kernels: second derivatives are exact.  The grid cotangents of
hess and pushhess need third and fourth derivatives; there, as the JAX
package does, PyTorch's autograd differentiates the plain
``ndkernels.hess_core`` on every device.

**Fused forwards**, as the JAX scattered tier's ``_pullgrad_sc`` /
``_gradhess_sc`` (``scattered.py:768-933``): when the grid needs a
gradient, pull's forward runs value and gradient in one kernel launch and
grad's forward gradient and Hessian.  The extra planes are a second output
of ``PullGrad`` / ``GradHess``, saved for the backward; both Functions have
backward rules of their own, so a backward that uses the planes stays
exact at second order.

**Dispatch** by the tensor's device: a CPU tensor runs the plain cores of
``ops/ndkernels.py``; a CUDA tensor with D in {1, 2, 3} the kernels
(``ops/cuda_scattered.py``: ``csrc/gather.cu``, ``csrc/splat.cu``), for
every number of points (the JAX package's ``MIN_POINTS`` is a TPU
threshold and is not ported).  D > 3 runs the plain cores on every device,
as the JAX package runs its XLA core there.

Layouts are the kernel layouts: input (B, C, *ishape), grid
(B, *oshape, D).
"""
from __future__ import annotations

import torch

from . import ndkernels as nd

__all__ = ["pull", "push", "count", "grad", "pushgrad", "hess", "pushhess",
           "Pull", "PullGrad", "Grad", "GradHess", "Hess", "Push", "Count",
           "Pushgrad", "Pushhess"]


# ------------------------------------------------------------ dispatch
# ``opts`` = (orders, bounds, extrapolate); grids are flat (B, P, D) and
# contiguous; inputs detached.

def _on_kernel(t, grid):
    return t.device.type == "cuda" and grid.shape[-1] <= 3


def _gather(inp, grid, opts, value=False, grad=False, hess=False):
    """(val, grad, hess) of the kernel or the plain cores."""
    if _on_kernel(inp, grid):
        from .cuda_scattered import gather_cuda
        return gather_cuda(inp.contiguous(), grid, *opts, value=value,
                           grad=grad, hess=hess)
    return (nd.pull_core(inp, grid, *opts) if value else None,
            nd.grad_core(inp, grid, *opts) if grad else None,
            nd.hess_core(inp, grid, *opts) if hess else None)


_PLAIN_SPLAT = {"push": nd.push_core, "pushgrad": nd.pushgrad_core,
                "pushhess": nd.pushhess_core}


def _splat(vals, grid, oshape, opts, spec):
    if _on_kernel(vals, grid):
        from .cuda_scattered import splat_cuda
        return splat_cuda(vals.contiguous(), grid, oshape, *opts, spec=spec)
    return _PLAIN_SPLAT[spec](vals, grid, oshape, *opts)


def _hess_vjp_grid(inp, grid, ct, opts):
    """d/dgrid <hess(inp, grid), ct>: PyTorch's autograd of the plain
    hess core (third order), differentiable again when grad mode is on."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        g = grid if create else grid.detach().requires_grad_()
        h = nd.hess_core(inp if create else inp.detach(), g, *opts)
        return torch.autograd.grad(h, g, ct.to(h.dtype),
                                   create_graph=create)[0]


def _wants_grid(grid):
    return torch.is_grad_enabled() and grid.requires_grad


# ---------------------------------------------- differentiable flat ops

def _pull(inp, grid, opts):
    if _wants_grid(grid):
        return PullGrad.apply(inp, grid, opts)[0]
    return Pull.apply(inp, grid, opts)


def _grad(inp, grid, opts):
    if _wants_grid(grid):
        return GradHess.apply(inp, grid, opts)[0]
    return Grad.apply(inp, grid, opts)


def _d_grid_grad(h, ct):
    """sum_{C, D2} hess . ct: (B, C, P, D, D), (B, C, P, D) -> (B, P, D)."""
    return (h * ct[..., None]).sum((1, -2))


def _save(ctx, opts, *tensors):
    ctx.opts = opts
    ctx.save_for_backward(*tensors)
    return tuple(t.detach() for t in tensors)


# ----------------------------------------------------------- Functions

class Pull(torch.autograd.Function):
    """pull; backward: d_inp = push(ct), d_grid = sum_C grad(inp) ct."""

    @staticmethod
    def forward(ctx, inp, grid, opts):
        inp, grid = _save(ctx, opts, inp, grid)
        return _gather(inp, grid, opts, value=True)[0]

    @staticmethod
    def backward(ctx, ct):
        inp, grid = ctx.saved_tensors
        opts, ct = ctx.opts, ct.contiguous()
        d_inp = d_grid = None
        if ctx.needs_input_grad[0]:
            d_inp = Push.apply(ct, grid, tuple(inp.shape[2:]), opts)
            d_inp = d_inp.to(inp.dtype)
        if ctx.needs_input_grad[1]:
            d_grid = (_grad(inp, grid, opts) * ct[..., None]).sum(1)
            d_grid = d_grid.to(grid.dtype)
        return d_inp, d_grid, None


class PullGrad(torch.autograd.Function):
    """Fused value + gradient (one kernel launch); backward: d_inp =
    push(ct_v) + pushgrad(ct_g), d_grid = sum_C g ct_v + sum hess ct_g."""

    @staticmethod
    def forward(ctx, inp, grid, opts):
        inp_d, grid_d = inp.detach(), grid.detach()
        val, g, _ = _gather(inp_d, grid_d, opts, value=True, grad=True)
        ctx.opts = opts
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(inp, grid, g)
        return val, g

    @staticmethod
    def backward(ctx, ct_v, ct_g):
        inp, grid, g = ctx.saved_tensors
        opts, ishape = ctx.opts, tuple(inp.shape[2:])
        d_inp = d_grid = None
        if ctx.needs_input_grad[0]:
            terms = []
            if ct_v is not None:
                terms.append(Push.apply(ct_v.contiguous(), grid, ishape, opts))
            if ct_g is not None:
                terms.append(Pushgrad.apply(ct_g.contiguous(), grid,
                                            ishape, opts))
            d_inp = sum(terms).to(inp.dtype) if terms else None
        if ctx.needs_input_grad[1]:
            terms = []
            if ct_v is not None:
                terms.append((g * ct_v[..., None]).sum(1))
            if ct_g is not None:
                terms.append(_d_grid_grad(Hess.apply(inp, grid, opts), ct_g))
            d_grid = sum(terms).to(grid.dtype) if terms else None
        return d_inp, d_grid, None


class Grad(torch.autograd.Function):
    """grad; backward: d_inp = pushgrad(ct), d_grid = sum hess(inp) ct."""

    @staticmethod
    def forward(ctx, inp, grid, opts):
        inp, grid = _save(ctx, opts, inp, grid)
        return _gather(inp, grid, opts, grad=True)[1]

    @staticmethod
    def backward(ctx, ct):
        inp, grid = ctx.saved_tensors
        opts, ct = ctx.opts, ct.contiguous()
        d_inp = d_grid = None
        if ctx.needs_input_grad[0]:
            d_inp = Pushgrad.apply(ct, grid, tuple(inp.shape[2:]), opts)
            d_inp = d_inp.to(inp.dtype)
        if ctx.needs_input_grad[1]:
            d_grid = _d_grid_grad(Hess.apply(inp, grid, opts), ct)
            d_grid = d_grid.to(grid.dtype)
        return d_inp, d_grid, None


class GradHess(torch.autograd.Function):
    """Fused gradient + Hessian (one kernel launch); backward: d_inp =
    pushgrad(ct_g) + pushhess(ct_h), d_grid = sum h ct_g + the plain
    third-order VJP of ct_h."""

    @staticmethod
    def forward(ctx, inp, grid, opts):
        inp_d, grid_d = inp.detach(), grid.detach()
        _, g, h = _gather(inp_d, grid_d, opts, grad=True, hess=True)
        ctx.opts = opts
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(inp, grid, h)
        return g, h

    @staticmethod
    def backward(ctx, ct_g, ct_h):
        inp, grid, h = ctx.saved_tensors
        opts, ishape = ctx.opts, tuple(inp.shape[2:])
        d_inp = d_grid = None
        if ctx.needs_input_grad[0]:
            terms = []
            if ct_g is not None:
                terms.append(Pushgrad.apply(ct_g.contiguous(), grid,
                                            ishape, opts))
            if ct_h is not None:
                terms.append(Pushhess.apply(ct_h.contiguous(), grid,
                                            ishape, opts))
            d_inp = sum(terms).to(inp.dtype) if terms else None
        if ctx.needs_input_grad[1]:
            terms = []
            if ct_g is not None:
                terms.append(_d_grid_grad(h, ct_g))
            if ct_h is not None:
                terms.append(_hess_vjp_grid(inp, grid, ct_h, opts))
            d_grid = sum(terms).to(grid.dtype) if terms else None
        return d_inp, d_grid, None


class Hess(torch.autograd.Function):
    """hess; backward: d_inp = pushhess(ct), d_grid = the VJP of the plain
    hess core through PyTorch's autograd (third order, on every device)."""

    @staticmethod
    def forward(ctx, inp, grid, opts):
        inp, grid = _save(ctx, opts, inp, grid)
        return _gather(inp, grid, opts, hess=True)[2]

    @staticmethod
    def backward(ctx, ct):
        inp, grid = ctx.saved_tensors
        opts, ct = ctx.opts, ct.contiguous()
        d_inp = d_grid = None
        if ctx.needs_input_grad[0]:
            d_inp = Pushhess.apply(ct, grid, tuple(inp.shape[2:]), opts)
            d_inp = d_inp.to(inp.dtype)
        if ctx.needs_input_grad[1]:
            d_grid = _hess_vjp_grid(inp, grid, ct, opts).to(grid.dtype)
        return d_inp, d_grid, None


class Push(torch.autograd.Function):
    """push; backward: d_inp = pull(ct), d_grid = sum_C grad(ct) inp (one
    fused launch when both are asked for)."""

    @staticmethod
    def forward(ctx, vals, grid, oshape, opts):
        vals, grid = _save(ctx, opts, vals, grid)
        return _splat(vals, grid, oshape, opts, "push")

    @staticmethod
    def backward(ctx, ct):
        vals, grid = ctx.saved_tensors
        opts, ct = ctx.opts, ct.contiguous()
        need_v, need_g = ctx.needs_input_grad[:2]
        d_vals = d_grid = g = None
        if need_v and need_g:
            d_vals, g = PullGrad.apply(ct, grid, opts)
        elif need_v:
            d_vals = _pull(ct, grid, opts)
        elif need_g:
            g = _grad(ct, grid, opts)
        if d_vals is not None:
            d_vals = d_vals.to(vals.dtype)
        if g is not None:
            d_grid = (g * vals[..., None]).sum(1).to(grid.dtype)
        return d_vals, d_grid, None, None


class Count(torch.autograd.Function):
    """count; backward: d_grid = sum_C grad(ct)."""

    @staticmethod
    def forward(ctx, grid, oshape, opts):
        (grid,) = _save(ctx, opts, grid)
        ones = grid.new_ones((grid.shape[0], 1, grid.shape[1]))
        return _splat(ones, grid, oshape, opts, "push")

    @staticmethod
    def backward(ctx, ct):
        (grid,) = ctx.saved_tensors
        d_grid = None
        if ctx.needs_input_grad[0]:
            d_grid = _grad(ct.contiguous(), grid, ctx.opts).sum(1)
            d_grid = d_grid.to(grid.dtype)
        return d_grid, None, None


class Pushgrad(torch.autograd.Function):
    """pushgrad; backward: d_inp = grad(ct), d_grid = sum hess(ct) inp
    (one fused launch when both are asked for)."""

    @staticmethod
    def forward(ctx, vals, grid, oshape, opts):
        vals, grid = _save(ctx, opts, vals, grid)
        return _splat(vals, grid, oshape, opts, "pushgrad")

    @staticmethod
    def backward(ctx, ct):
        vals, grid = ctx.saved_tensors
        opts, ct = ctx.opts, ct.contiguous()
        need_v, need_g = ctx.needs_input_grad[:2]
        d_vals = d_grid = h = None
        if need_v and need_g:
            d_vals, h = GradHess.apply(ct, grid, opts)
        elif need_v:
            d_vals = _grad(ct, grid, opts)
        elif need_g:
            h = Hess.apply(ct, grid, opts)
        if d_vals is not None:
            d_vals = d_vals.to(vals.dtype)
        if h is not None:
            d_grid = _d_grid_grad(h, vals).to(grid.dtype)
        return d_vals, d_grid, None, None


class Pushhess(torch.autograd.Function):
    """pushhess, the adjoint of hess in the image; backward: d_inp =
    hess(ct), d_grid = the plain fourth-order VJP."""

    @staticmethod
    def forward(ctx, vals, grid, oshape, opts):
        vals, grid = _save(ctx, opts, vals, grid)
        return _splat(vals, grid, oshape, opts, "pushhess")

    @staticmethod
    def backward(ctx, ct):
        vals, grid = ctx.saved_tensors
        opts, ct = ctx.opts, ct.contiguous()
        d_vals = d_grid = None
        if ctx.needs_input_grad[0]:
            d_vals = Hess.apply(ct, grid, opts).to(vals.dtype)
        if ctx.needs_input_grad[1]:
            # <u, pushhess(v, grid)> = <hess(u, grid), v>
            d_grid = _hess_vjp_grid(ct, grid, vals, opts).to(grid.dtype)
        return d_vals, d_grid, None, None


# ------------------------------------------------------- public (kernel
# layouts: input (B, C, *ishape), grid (B, *oshape, D))

def _flat(grid):
    """(B, *oshape, D) -> contiguous (B, P, D), differentiably, and
    oshape."""
    oshape = tuple(grid.shape[1:-1])
    return grid.reshape(grid.shape[0], -1, grid.shape[-1]).contiguous(), \
        oshape


def _opts(orders, bounds, extrapolate):
    return (tuple(int(o) for o in orders), tuple(int(b) for b in bounds),
            int(extrapolate))


def pull(inp, grid, orders, bounds, extrapolate):
    """(B, C, *ishape), (B, *oshape, D) -> (B, C, *oshape)."""
    gflat, oshape = _flat(grid)
    out = _pull(inp, gflat, _opts(orders, bounds, extrapolate))
    return out.reshape(out.shape[:2] + oshape)


def grad(inp, grid, orders, bounds, extrapolate):
    """(B, C, *ishape), (B, *oshape, D) -> (B, C, *oshape, D)."""
    gflat, oshape = _flat(grid)
    out = _grad(inp, gflat, _opts(orders, bounds, extrapolate))
    return out.reshape(out.shape[:2] + oshape + out.shape[-1:])


def hess(inp, grid, orders, bounds, extrapolate):
    """(B, C, *ishape), (B, *oshape, D) -> (B, C, *oshape, D, D)."""
    gflat, oshape = _flat(grid)
    out = Hess.apply(inp, gflat, _opts(orders, bounds, extrapolate))
    return out.reshape(out.shape[:2] + oshape + out.shape[-2:])


def push(inp, grid, oshape, orders, bounds, extrapolate):
    """(B, C, *ishape), (B, *ishape, D) -> (B, C, *oshape), the adjoint of
    :func:`pull`."""
    gflat, _ = _flat(grid)
    vals = inp.reshape(inp.shape[:2] + (-1,))
    return Push.apply(vals, gflat, tuple(int(s) for s in oshape),
                      _opts(orders, bounds, extrapolate))


def count(grid, oshape, orders, bounds, extrapolate):
    """(B, *ishape, D) -> (B, 1, *oshape): splatted unit weights."""
    gflat, _ = _flat(grid)
    return Count.apply(gflat, tuple(int(s) for s in oshape),
                       _opts(orders, bounds, extrapolate))


def pushgrad(inp, grid, oshape, orders, bounds, extrapolate):
    """(B, C, *ishape, D), (B, *ishape, D) -> (B, C, *oshape), the adjoint
    of :func:`grad` in the image."""
    gflat, _ = _flat(grid)
    D = grid.shape[-1]
    vals = inp.reshape(inp.shape[:2] + (-1, D))
    return Pushgrad.apply(vals, gflat, tuple(int(s) for s in oshape),
                          _opts(orders, bounds, extrapolate))


def pushhess(inp, grid, oshape, orders, bounds, extrapolate):
    """(B, C, *ishape, D, D), (B, *ishape, D) -> (B, C, *oshape), the
    adjoint of :func:`hess` in the image."""
    gflat, _ = _flat(grid)
    D = grid.shape[-1]
    vals = inp.reshape(inp.shape[:2] + (-1, D, D))
    return Pushhess.apply(vals, gflat, tuple(int(s) for s in oshape),
                          _opts(orders, bounds, extrapolate))

