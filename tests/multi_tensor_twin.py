"""The guarded clip → SGD → apply of ``optim.clip_sgd_step`` written as plain
torch ops with the norm as an argument: the reference that the kernel of
``ops/multi_tensor.py`` is held to bit for bit given its own norm (the card
tests, ``chip_smoke.py``). ``tests/test_torch_multi_tensor.py`` holds it to
``guard_finite`` → chain(clip, sgd).update → ``apply_updates`` bit for bit
when it computes the norm itself."""

from typing import Optional, Sequence

import torch

from manuscript_tpu_torch.ops.multi_tensor import global_norm


def clip_sgd_apply_twin(loss: torch.Tensor, grads: Sequence[torch.Tensor],
                        traces: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
                        max_norm: float, step: float, momentum: float,
                        norm: Optional[torch.Tensor] = None) -> None:
    """g ← 0 unless the loss is finite; g ← (g / ‖g‖)·max where ‖g‖ ≥ max;
    t ← g + momentum·t; p ← p + step·t, in place (``step`` is −lr).
    ``norm`` replaces the guarded gradients' norm."""
    finite = torch.isfinite(loss)
    grads = [torch.where(finite, g, torch.zeros_like(g)) for g in grads]
    if norm is None:
        norm = global_norm(grads)
    keep = norm < max_norm
    for g, t, p in zip(grads, traces, params):
        t.copy_(torch.where(keep, g, (g / norm) * max_norm) + momentum * t)
        p.add_(step * t)
