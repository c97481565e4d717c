"""The reference's train steps: the frozen detector's loss, autograd's
gradients, the global-norm clip and a plain SGD (momentum, decoupled
nothing: the decay added to the gradient) or AdamW update, written out
here rather than taken from ``torch.optim``."""
from __future__ import annotations

from typing import Dict, List

import torch

from . import model as M


def tf32(enabled: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = bool(enabled)
    torch.backends.cudnn.allow_tf32 = bool(enabled)


class PlainOptimizer:
    """SGD with momentum (mmcv / torch semantics, dampening 0) or AdamW,
    over the frozen parameter groups of the configuration."""

    def __init__(self, cfg: dict, named_params):
        self.cfg = dict(cfg['optimizer'])
        self.groups = M.param_groups(self.cfg, named_params)
        self.state = {}
        self.t = 0

    @torch.no_grad()
    def step(self, lr: float):
        self.t += 1
        kind = self.cfg.get('type', 'SGD')
        for g in self.groups:
            glr = lr * g['lr_mult']
            wd = g['weight_decay']
            for p in g['params']:
                grad = p.grad
                st = self.state.setdefault(p, {})
                if kind == 'SGD':
                    d = grad + wd * p if wd else grad.clone()
                    mom = self.cfg.get('momentum', 0.0)
                    if mom:
                        if 'buf' not in st:
                            st['buf'] = d.clone()
                        else:
                            st['buf'].mul_(mom).add_(d)
                        d = st['buf']
                    p.sub_(glr * d)
                elif kind == 'AdamW':
                    b1, b2 = self.cfg.get('betas', (0.9, 0.999))
                    eps = self.cfg.get('eps', 1e-8)
                    p.mul_(1.0 - glr * wd)
                    if 'm' not in st:
                        st['m'] = torch.zeros_like(p)
                        st['v'] = torch.zeros_like(p)
                    st['m'].mul_(b1).add_(grad, alpha=1.0 - b1)
                    st['v'].mul_(b2).addcmul_(grad, grad, value=1.0 - b2)
                    c1 = 1.0 - b1 ** self.t
                    c2 = 1.0 - b2 ** self.t
                    denom = (st['v'] / c2).sqrt_().add_(eps)
                    p.sub_(glr * (st['m'] / c1) / denom)
                else:
                    raise ValueError(f'optimizer {kind}')


def leaf_norms(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.detach().float().norm() for t in tensors])


def run_steps(cfg: dict, weights: Dict[str, torch.Tensor],
              batches: List[dict], start_step: int, device,
              tf32_on: bool = False) -> dict:
    """The reference over ``batches`` (numpy batches of the frozen
    batcher), from ``weights``: each step's total loss, each leaf's
    gradient norm at step 1 as the update takes it (after the clip), and
    each leaf's change over all the steps. Leaves in ``weights`` order."""
    tf32(tf32_on)
    model = M.build(cfg, device)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for k, w in weights.items():
            params[k].copy_(w)
    names = list(weights)
    plist = [params[k] for k in names]
    start = [p.detach().clone() for p in plist]
    opt = PlainOptimizer(cfg, [(k, params[k]) for k in names])
    lr_fn = M.lr_schedule(cfg)
    clip = (cfg.get('optimizer_config') or {}).get('grad_clip')
    losses, grad1 = [], None
    for i, batch in enumerate(batches):
        model.train()
        step = start_step + i
        out = model.loss(M.to_device(batch, device), step)
        total = sum(v for k, v in out.items() if 'loss' in k)
        grads = torch.autograd.grad(total, plist, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, plist)]
        if clip:
            norm = torch.linalg.vector_norm(torch.stack(
                [g.norm() for g in grads]))
            scale = torch.clamp(clip['max_norm'] / (norm + 1e-6), max=1.0)
            grads = [g * scale for g in grads]
        for p, g in zip(plist, grads):
            p.grad = g
        if i == 0:
            grad1 = leaf_norms(grads)
        opt.step(lr_fn(step))
        for p in plist:
            p.grad = None
        losses.append(float(total.detach()))
    change = leaf_norms([p - s for p, s in zip(plist, start)])
    tf32(False)
    return dict(losses=losses, grad1=grad1.cpu(), change=change.cpu(),
                names=names)
