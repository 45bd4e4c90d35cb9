"""The optax transformations the JAX trainers use, in torch: the same
arithmetic and the same state layout, so a checkpoint of either package
restores into the other.

A state is the tuple of its transformations' states (`chain`), each a
NamedTuple with optax's fields and order: `EmptyState()` for the clip and
a constant learning rate, `ScaleByAdamState(count, mu, nu)`,
`ScaleByScheduleState(count)`. Counts are int32 scalars on the
parameters' device; mu and nu are trees shaped like the parameters.
Trees are nested dicts, lists and tuples of tensors.

- `clip_by_global_norm`: t -> t / norm * max_norm only when norm >=
  max_norm (no epsilon is added, unlike `torch.nn.utils.clip_grad_norm_`);
  the norm of a tree sharded over ranks comes from a given `norm_fn`.
- `scale_by_adam`: eps outside the square root, bias correction by
  1 - b**count in float32 with the count after the update.
- `scale_by_learning_rate`: multiplies by -lr(count), the count before the
  update; `exponential_decay` with `staircase` halves at whole multiples
  of `transition_steps`.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple, Union

import torch


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of trees of one structure (dicts, lists, tuples;
    NamedTuples keep their type)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def value_and_grad(fn: Callable[[Any], Any], params: Any,
                   frozen: Tuple[str, ...] = ()):
    """(loss, aux, grads) of `loss, aux = fn(params)` by autograd: fn gets
    a copy of params whose leaves require grad, except the leaves under a
    key in `frozen`; grads is a tree shaped like params, zero at frozen
    leaves and at leaves the loss does not use."""
    leaves: List[torch.Tensor] = []
    mask: List[bool] = []

    def live(node, key=""):
        if isinstance(node, dict):
            return {k: live(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [live(v, key) for v in node]
        mask.append(key not in frozen)
        if not mask[-1]:
            return node
        leaves.append(node.detach().requires_grad_(True))
        return leaves[-1]

    with torch.enable_grad():
        loss, aux = fn(live(params))
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    flags = iter(mask)

    def grad_of(p):
        g = next(grads) if next(flags) else None
        return torch.zeros_like(p) if g is None else g
    return loss.detach(), aux, tree_map(grad_of, params)


def _count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _device(tree: Any):
    return tree_leaves(tree)[0].device


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum((x * x).sum() for x in tree_leaves(tree)))


def clip_by_global_norm(max_norm: float,
                        norm_fn: Callable[[Any], torch.Tensor] = None
                        ) -> GradientTransformation:
    """`norm_fn` (default `global_norm`) gives the norm of the whole
    update tree; a sharded tree passes one that sums over its shards."""
    norm_fn = norm_fn or global_norm

    def update(updates, state, params=None):
        norm = norm_fn(updates)
        clip = norm >= max_norm
        return tree_map(lambda t: torch.where(clip, t / norm * max_norm, t),
                        updates), state
    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        return ScaleByAdamState(
            _count(_device(params)), tree_map(torch.zeros_like, params),
            tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, updates, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * g * g + b2 * v, updates,
                      state.nu)
        count = state.count + 1
        c1 = 1 - torch.tensor(b1, dtype=torch.float32,
                              device=count.device) ** count
        c2 = 1 - torch.tensor(b2, dtype=torch.float32,
                              device=count.device) ** count
        out = tree_map(lambda m, v: (m / c1) / (torch.sqrt(v / c2) + eps),
                       mu, nu)
        return out, ScaleByAdamState(count, mu, nu)
    return GradientTransformation(init, update)


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float, staircase: bool = False
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """lr(count) = init_value * decay_rate ** (count / transition_steps),
    the exponent floored with `staircase`, in float32."""
    def schedule(count: torch.Tensor) -> torch.Tensor:
        p = count.float() / transition_steps
        if staircase:
            p = torch.floor(p)
        f32 = dict(dtype=torch.float32, device=count.device)
        lr = torch.tensor(init_value, **f32) \
            * torch.tensor(decay_rate, **f32) ** p
        return torch.where(count <= 0, torch.tensor(init_value, **f32), lr)
    return schedule


def scale_by_learning_rate(lr: Union[float, Callable]
                           ) -> GradientTransformation:
    """Multiply by -lr; a schedule is read at the count before this
    update and keeps its own count."""
    if not callable(lr):
        return GradientTransformation(
            lambda params: EmptyState(),
            lambda updates, state, params=None: (
                tree_map(lambda g: g * -lr, updates), state))

    def update(updates, state, params=None):
        step = -lr(state.count)
        return (tree_map(lambda g: step.to(g.dtype) * g, updates),
                ScaleByScheduleState(state.count + 1))
    return GradientTransformation(
        lambda params: ScaleByScheduleState(_count(_device(params))), update)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)
    return GradientTransformation(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """optax.adam: (ScaleByAdamState, EmptyState)."""
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(lr))


def apply_updates(params: Any, updates: Any) -> Any:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


__all__ = ["EmptyState", "ScaleByAdamState", "ScaleByScheduleState",
           "GradientTransformation", "tree_map", "tree_leaves",
           "value_and_grad",
           "global_norm", "clip_by_global_norm", "scale_by_adam",
           "exponential_decay", "scale_by_learning_rate", "chain", "adam",
           "apply_updates"]
