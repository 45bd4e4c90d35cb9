"""Utilities of the port: image reading without cv2 (`imageio`) and
training checkpoints in the JAX package's `.npz` layout (`checkpoint`)."""

from .checkpoint import (latest_checkpoint, load_params_from_checkpoint,
                         restore_checkpoint, resume_or_init, save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_checkpoint",
           "resume_or_init", "load_params_from_checkpoint"]
