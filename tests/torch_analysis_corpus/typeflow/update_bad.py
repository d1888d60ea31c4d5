# corpus-rules: donation, dtypeflow
"""An update step (registered update_step=True by the test) that loses
its updates: rebinding parameters and moments, replacing dict entries,
and writing into casts of the state.  The in-place shapes stay quiet."""

import torch


class LossyOptimizer:
    def __init__(self, params):
        self.params = dict(params)
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    @torch.no_grad()
    def step(self, grads, lr):
        for k, p in self.params.items():
            g = grads[k]
            mu = self.mu[k]
            mu.mul_(0.9).add_(g)                 # negative: in place
            p.float().add_(mu)  # expect: CST-DTY-004
            p.to(torch.float32).copy_(p - lr * mu)  # expect: CST-DTY-004
            mu = mu * 0.9  # expect: CST-DON-001
            self.mu[k] = mu  # expect: CST-DON-001
            p = p - lr * mu  # expect: CST-DON-001
        torch._foreach_add_(list(self.params.values()), 1.0)
        self.mu = {k: v.clone() for k, v in self.mu.items()}  # expect: CST-DON-001
