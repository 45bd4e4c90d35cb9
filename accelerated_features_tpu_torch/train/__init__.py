"""Training of the port: the XFeat trainer (`trainer`, `run`), the
LighterGlue trainer (`lighterglue_loss`, `lighterglue_run`), their losses,
ground truth (`warp`, `augmentation`), optimizer (`optim`, optax's
arithmetic and state layout) and data (`megadepth`: MegaDepth's layout
without h5py or cv2, and the synthetic image pool; `render`)."""

from .losses import (coordinate_classification_loss, distill_labels_from_kpts,
                     distill_loss, dual_softmax_loss, hard_triplet_loss,
                     keypoint_reliability_loss)
from .trainer import (TrainConfig, init_train_state, loss_fn,
                      make_optimizer, make_sharded_train_step, train_step)

__all__ = [
    "dual_softmax_loss", "coordinate_classification_loss",
    "keypoint_reliability_loss", "distill_labels_from_kpts", "distill_loss",
    "hard_triplet_loss", "TrainConfig", "init_train_state", "loss_fn",
    "make_optimizer", "train_step", "make_sharded_train_step",
]
