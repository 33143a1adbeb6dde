"""Adam (+ AMSGrad) with the JAX package's arithmetic
(``pytorch_distributed_nn_tpu/optim/adam.py``):

    g      = grad + weight_decay * p
    m      = b1 * m + (1 - b1) * g
    v      = b2 * v + (1 - b2) * g^2
    v_eff  = max(v_max, v) if amsgrad else v      (v_max accumulated)
    p     += -(lr / (1 - b1^t)) * m / (sqrt(v_eff) / sqrt(1 - b2^t) + eps)

The bias corrections are computed in float32, as the JAX optimizer
computes them (``torch.optim.Adam`` takes them in double: at t = 1,
``1 - 0.999`` differs by 1.3e-5 relative between the two, enough to move
a parameter by 1e-6 in three steps). All parameters update in one
``torch._foreach_*`` pass per operation.
"""

from __future__ import annotations

import torch


class Adam(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 amsgrad: bool = False):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      amsgrad=amsgrad))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params,
                                           alpha=group["weight_decay"])
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st["step"] = 0
                    st["m"] = torch.zeros_like(p)
                    st["v"] = torch.zeros_like(p)
                    if group["amsgrad"]:
                        st["v_max"] = torch.zeros_like(p)
                st["step"] += 1
            t = states[0]["step"]
            f32 = torch.float32
            bc1 = float(1.0 - torch.tensor(b1, dtype=f32) ** t)
            bc2 = float(1.0 - torch.tensor(b2, dtype=f32) ** t)
            m = [st["m"] for st in states]
            v = [st["v"] for st in states]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(
                v, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                      1.0 - b2))
            if group["amsgrad"]:
                v_eff = [st["v_max"] for st in states]
                torch._foreach_maximum_(v_eff, v)
            else:
                v_eff = v
            step_size = float(torch.tensor(group["lr"], dtype=f32)
                              / torch.tensor(bc1, dtype=f32))
            denom = torch._foreach_sqrt(v_eff)
            torch._foreach_div_(denom, float(torch.tensor(bc2, dtype=f32)
                                             .sqrt()))
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_mul(m, -step_size)
            torch._foreach_div_(upd, denom)
            torch._foreach_add_(params, upd)
