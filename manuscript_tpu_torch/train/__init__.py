"""Training for the port (counterpart of ``manuscript_tpu/train``): losses,
optax-equivalent optimizers, metrics, checkpoints, datasets and the two
trainers, ``trba_train.train`` and ``east_train.train`` (also reached as
``TRBA.train`` and ``EAST.train``)."""

from .losses import dice_loss, east_loss, soft_dice_coefficient, trba_ce_loss
from .metrics import (
    aggregate_text_metrics,
    character_error_rate,
    compute_accuracy,
    compute_f1,
    compute_f1_metrics,
    poly_iou,
    word_error_rate,
)
from .optim import (
    build_east_optimizer,
    build_trba_optimizer,
    cosine_warm_restarts,
    ema_update,
    lookahead,
    sam_gradient,
)
