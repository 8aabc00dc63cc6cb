"""Optimizers with the JAX package's (optax's) semantics, written out
(counterpart of `yolov3_tensorflow_tpu/train/optimizers.py`).

The chain, per parameter leaf: clip the gradient to norm `grad_clip_norm`
(per leaf, not global: scale min(1, max_norm / max(norm, 1e-20))), then the
core rule, then multiply by -lr(count), where `count` counts this
optimizer's updates from 0: under a warm-up that starts at 0 the first
update is zero, as optax's `scale_by_learning_rate` makes it. The rules:

- momentum: a = m * a + g (optax.trace)
- rmsprop: nu = 0.9 * nu + 0.1 * g^2 from nu = 0, g * rsqrt(nu + 1e-10)
  (eps inside the root: optax.scale_by_rms's defaults, not
  torch.optim.RMSprop's), then a momentum trace
- adam: b1 0.9, b2 0.999, eps 1e-8 outside the root, bias-corrected
- sgd: the clipped gradient

`update_mask` freezes leaves by path: a frozen leaf gets no update (it has
none in the updates, so `apply_updates` leaves it as it was; JAX adds an
exact zero) and holds no optimizer state. The state is a plain dict,
{"count": int, slot name: {leaf path: tensor}}, so that checkpoints carry
it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

Tree = Dict[str, Any]
SLOTS = {"momentum": ("trace",), "rmsprop": ("nu", "trace"),
         "adam": ("mu", "nu"), "sgd": ()}
RMS_EPS = 1e-10
ADAM = dict(b1=0.9, b2=0.999, eps=1e-8)


def flatten(tree: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict of tensors -> {"a/b/c": tensor}, in insertion order."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten(value, path + "/"))
        else:
            out[path] = value
    return out


def unflatten(flat: Dict[str, Any]) -> Tree:
    """Inverse of `flatten`."""
    tree: Tree = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def path_prefix_mask(params: Tree, include: Optional[Sequence[str]]
                     ) -> Dict[str, bool]:
    """{leaf path: True} where the '/'-joined path starts with, or has a
    '/'-separated part starting with, any of `include` (None: every leaf)."""

    def match(key: str) -> bool:
        if include is None:
            return True
        return any(key.startswith(pref) or f"/{pref}" in key
                   for pref in include)

    return {path: match(path) for path in flatten(params)}


def clip_by_per_leaf_norm(grads: List[torch.Tensor], max_norm: float
                          ) -> List[torch.Tensor]:
    """Each gradient scaled to norm at most `max_norm`, independently."""
    if not grads:
        return grads
    norms = torch.stack(torch._foreach_norm(grads))
    scales = torch.clamp(max_norm / torch.clamp(norms, min=1e-20), max=1.0)
    return list(torch._foreach_mul(grads, list(scales.unbind())))


class Optimizer:
    """clip -> core rule -> -lr(count), over the unfrozen leaves.

    `init(params)` makes the state; `update(grads, state)` takes the
    gradients of the unfrozen leaves ({path: tensor}, the paths of
    `trainable(params)`) and returns ({path: update}, new state)."""

    def __init__(self, name: str, schedule: Callable[[int], float], *,
                 momentum: float = 0.9, rmsprop_decay: float = 0.9,
                 grad_clip_norm: Optional[float] = 100.0,
                 update_mask: Optional[Dict[str, bool]] = None):
        if name not in SLOTS:
            raise ValueError(f"unsupported optimizer: {name!r}")
        self.name = name
        self.schedule = schedule
        self.momentum = momentum
        self.rmsprop_decay = rmsprop_decay
        self.grad_clip_norm = grad_clip_norm
        self.update_mask = update_mask

    def trainable(self, params: Tree) -> List[str]:
        """The paths of the leaves this optimizer updates."""
        paths = list(flatten(params))
        if self.update_mask is None:
            return paths
        return [p for p in paths if self.update_mask[p]]

    def init(self, params: Tree) -> Dict[str, Any]:
        flat = flatten(params)
        keep = self.trainable(params)
        state: Dict[str, Any] = {"count": 0}
        for slot in SLOTS[self.name]:
            state[slot] = {p: torch.zeros_like(flat[p]) for p in keep}
        return state

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: Dict[str, Any]
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        paths = list(grads)
        count = int(state["count"])
        if not paths:       # an update mask that matches no leaf, as JAX's
            return {}, {**state, "count": count + 1}
        g = [grads[p] for p in paths]
        if self.grad_clip_norm is not None:
            g = clip_by_per_leaf_norm(g, self.grad_clip_norm)
        new_state: Dict[str, Any] = {"count": count + 1}

        def slot(name):
            return [state[name][p] for p in paths]

        def keep(name, values):
            new_state[name] = dict(zip(paths, values))

        if self.name == "momentum":
            u = torch._foreach_add(g, torch._foreach_mul(slot("trace"),
                                                         self.momentum))
            keep("trace", u)
        elif self.name == "rmsprop":
            d = self.rmsprop_decay
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(g, g), 1 - d),
                torch._foreach_mul(slot("nu"), d))
            scale = torch._foreach_rsqrt(torch._foreach_add(nu, RMS_EPS))
            u = torch._foreach_mul(scale, g)
            u = torch._foreach_add(u, torch._foreach_mul(slot("trace"),
                                                         self.momentum))
            keep("nu", nu)
            keep("trace", u)
        elif self.name == "adam":
            b1, b2, eps = ADAM["b1"], ADAM["b2"], ADAM["eps"]
            mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                    torch._foreach_mul(slot("mu"), b1))
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                torch._foreach_mul(slot("nu"), b2))
            mu_hat = torch._foreach_div(mu, 1 - b1 ** (count + 1))
            nu_hat = torch._foreach_div(nu, 1 - b2 ** (count + 1))
            u = torch._foreach_div(
                mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), eps))
            keep("mu", mu)
            keep("nu", nu)
        else:
            u = g
        u = torch._foreach_mul(u, -self.schedule(count))
        return dict(zip(paths, u)), new_state


def build_optimizer(name: str, schedule: Callable[[int], float], *,
                    momentum: float = 0.9, rmsprop_decay: float = 0.9,
                    grad_clip_norm: Optional[float] = 100.0,
                    update_mask: Optional[Dict[str, bool]] = None
                    ) -> Optimizer:
    """The clip -> rule -> learning-rate chain (see the module docstring)."""
    return Optimizer(name, schedule, momentum=momentum,
                     rmsprop_decay=rmsprop_decay,
                     grad_clip_norm=grad_clip_norm, update_mask=update_mask)


@torch.no_grad()
def apply_updates(params: Tree, updates: Dict[str, torch.Tensor]) -> Tree:
    """New params: p + u for every leaf with an update; the others are the
    same tensors."""
    flat = flatten(params)
    for path, u in updates.items():
        flat[path] = flat[path] + u
    return unflatten(flat)
