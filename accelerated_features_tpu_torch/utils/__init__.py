"""Utilities of the port: image reading and resizing without cv2
(`imageio`: PNG, JPEG), training checkpoints in the JAX package's `.npz`
layout, reading its orbax checkpoints too (`checkpoint`), host C++
libraries built by g++ at first use (`native`), and timers and
speed-of-light accounting on the card (`profiling`)."""

from .checkpoint import (latest_checkpoint, load_params_from_checkpoint,
                         restore_checkpoint, resume_or_init, save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_checkpoint",
           "resume_or_init", "load_params_from_checkpoint"]
