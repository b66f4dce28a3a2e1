"""AdamW with global-norm clipping and a warmup + cosine schedule — the port
of ``repro.optim.adamw``.

The reference's formula and cast points, on nested dicts of tensors:

* moments are kept in ``TrainConfig.optimizer_dtype`` (bf16 for the largest
  configs), and every update is computed in fp32 whatever the parameter and
  moment dtypes;
* gradients are scaled by ``min(1, grad_clip / max(global_norm, 1e-9))``,
  the norm taken over every gradient leaf in fp32;
* ``update = m_hat / (sqrt(v_hat) + eps)`` and the decay ``wd * p`` is added
  to it, both multiplied by the step's learning rate.
  ``torch.optim.AdamW`` computes another function (eps inside the bias
  correction, decay applied before the step), so it is not used.

``step``, the learning rate, the clip scale and the bias corrections are
tensors on the parameters' device: a step reads nothing back to the host.
:func:`adamw_update` writes the new parameters and moments **in place**
(under ``torch.no_grad``) and returns the same tensors, which is what
donating the state gives the reference: a caller must not keep the state it
passed in as the state before the step.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.config import torch_dtype
from repro_torch.layers.params import tree_leaves, tree_map

__all__ = ["init_opt_state", "adamw_update", "lr_schedule", "global_norm"]


def _is_leaf(x) -> bool:
    return not isinstance(x, dict)


def init_opt_state(params, moment_dtype=torch.float32) -> Dict[str, Any]:
    """Zero first and second moments in ``moment_dtype``, and a 0-d int32
    ``step`` on the parameters' device."""
    dt = torch_dtype(moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params, is_leaf=_is_leaf),
        "v": tree_map(zeros, params, is_leaf=_is_leaf),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def lr_schedule(step: torch.Tensor, tcfg) -> torch.Tensor:
    """Linear warmup then cosine decay to 10% of peak (a 0-d fp32 tensor on
    ``step``'s device)."""
    step = step.float()
    warm = torch.clamp_max(step / max(tcfg.warmup_steps, 1), 1.0)
    t = torch.clamp(
        (step - tcfg.warmup_steps) / max(tcfg.total_steps - tcfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * t))
    return tcfg.learning_rate * warm * cos


@torch.no_grad()
def adamw_update(grads, opt_state, params,
                 tcfg) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns ``(params, opt_state, metrics)``:
    the trees passed in, updated; ``metrics`` holds ``grad_norm`` and
    ``lr`` as 0-d device tensors."""
    opt_state["step"].add_(1)
    step = opt_state["step"]
    gnorm = global_norm(grads)
    scale = torch.clamp_max(tcfg.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = lr_schedule(step, tcfg)
    b1, b2, eps, wd = tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay
    stepf = step.float()
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf

    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"]), tree_leaves(params)):
        gf = g.float() * scale
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * torch.square(gf)
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        pf = p.float()
        p.copy_(pf - lr * (update + wd * pf))
        m.copy_(m_new)
        v.copy_(v_new)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
