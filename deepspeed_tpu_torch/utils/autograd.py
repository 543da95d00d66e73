"""The first-derivative-only rule of the port's ``torch.autograd.Function``\\ s."""

import functools

import torch


def once_differentiable(backward):
    """Mark a Function's ``backward`` as having no derivative of its own,
    as a JAX ``custom_vjp`` has none: run with grad mode on (a backward
    with ``create_graph=True``, the first half of a Hessian-vector
    product), it raises ``RuntimeError`` at once. ``torch.autograd.function.
    once_differentiable`` raises only if the second backward reaches its
    node; ``torch.autograd.grad`` never does and reports an unused input
    instead, and with ``allow_unused=True`` gives no derivative at all."""

    @functools.wraps(backward)
    def wrapper(ctx, *grads):
        if torch.is_grad_enabled():
            raise RuntimeError(f"cannot differentiate twice through {type(ctx).__name__}: its "
                               f"backward is a hand-written kernel (or its plain version) with no "
                               f"derivative of its own, as JAX's custom_vjp has none")
        return backward(ctx, *grads)

    return wrapper
