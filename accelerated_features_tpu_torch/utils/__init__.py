"""Utilities of the port: image reading without cv2 (`imageio`), training
checkpoints in the JAX package's `.npz` layout (`checkpoint`), and timers
and speed-of-light accounting on the card (`profiling`)."""

from .checkpoint import (latest_checkpoint, load_params_from_checkpoint,
                         restore_checkpoint, resume_or_init, save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_checkpoint",
           "resume_or_init", "load_params_from_checkpoint"]
