"""Learning-rate and BN-momentum schedules.

Counterpart of ``iou3dmatch_tpu/train/schedules.py``: stairstep lr decay
(pretrain.py defaults lr 1e-3 x0.1 at epochs 400/600/800) and the BN
momentum ``max(0.5 * 0.5^(epoch // 20), 0.001)`` (train.py:231-236), both
evaluated on the host once an epoch.
"""
BN_MOMENTUM_INIT = 0.5
BN_MOMENTUM_MAX = 0.001


def get_lr(epoch, base_lr, decay_steps, decay_rates):
    lr = base_lr
    for step_epoch, rate in zip(decay_steps, decay_rates):
        if epoch >= step_epoch:
            lr *= rate
    return lr


def get_bn_momentum(epoch, decay_step=20, decay_rate=0.5):
    return max(BN_MOMENTUM_INIT * decay_rate ** (epoch // decay_step), BN_MOMENTUM_MAX)
